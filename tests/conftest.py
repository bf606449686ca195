"""Test configuration: run everything on a virtual 8-device CPU mesh.

The reference validated multi-device behavior using the always-available CPU
OpenCL device (SURVEY.md §4); the analog here is XLA's virtual host devices.
XLA_FLAGS must be set before jax initializes its backends. The platform is
pinned through jax.config as well as the environment, so an accelerator
plugin cannot take over the default backend.

With ``HIPE_TESTS_ON_GPU=1`` the default backend is left alone, so the
card-only tests (marker ``gpu``) run on a CUDA device:
``HIPE_TESTS_ON_GPU=1 python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

if os.environ.get("HIPE_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")

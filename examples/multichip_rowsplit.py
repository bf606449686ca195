"""N-way row-split with halo exchange over a device mesh.

On a multi-GPU host this shards image rows across the cards with
`lax.ppermute` halo exchange; without cards, simulate the mesh with
virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/multichip_rowsplit.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> int:
    import jax
    import jax.numpy as jnp

    from hipe_tpu.ops import reference as oracle
    from hipe_tpu.parallel import mesh as meshlib
    from hipe_tpu.parallel.row_split import make_row_split_fn

    devs = jax.devices()
    n = len(devs)
    print(f"{n} devices: {devs[0].platform}")
    mesh = meshlib.make_mesh(n, axis=meshlib.ROW_AXIS)
    fn = make_row_split_fn(mesh, ("gaussian3", "sharpen", "edge"))

    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, size=(4, 8 * n, 64, 3), dtype=np.uint8)
    out = np.asarray(fn(jnp.asarray(batch)))

    want = oracle.sobel_edge_oracle(
        oracle.sharpen3x3_oracle(oracle.gaussian_blur_int_oracle(batch[0]))
    )
    err = np.max(np.abs(out[0].astype(int) - want.astype(int)))
    print(f"row-split chain over {n} shards: max-abs err vs oracle = {err}")

    # Ratio-weighted (uneven) ownership — the reference's split_row knob
    # generalized to N shards (padded windows of real rows, still exact).
    from hipe_tpu.parallel.row_split import make_weighted_row_split_fn

    weights = [1.0 + 0.5 * i for i in range(n)]
    wfn = make_weighted_row_split_fn(
        mesh, ("gaussian3", "sharpen", "edge"), weights=weights
    )
    wout = np.asarray(wfn(jnp.asarray(batch)))
    werr = np.max(np.abs(wout[0].astype(int) - want.astype(int)))
    print(f"weighted ({[round(w, 1) for w in weights]}) row-split: "
          f"max-abs err = {werr}")
    return 0 if err == 0 and werr == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

"""Full device transcode: JPEG in -> blur -> JPEG out, numeric work on GPU.

With decode_on_device + encode_on_device the host performs only the two
serial entropy stages (jpeg_read_coefficients / jpeg_write_coefficients);
dequantize, IDCT, upsample, color, the filter, color back, downsample,
forward DCT and quantization all run in ONE jitted device program —
quantized coefficients in, quantized coefficients out. Output files are
byte-identical to the host libjpeg codec's.

Usage: python examples/transcode.py [num_images] [batch_size]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    num_images = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    batch_size = int(sys.argv[2]) if len(sys.argv) > 2 else 16

    from hipe_tpu.io_.jpeg import encode_bytes
    from hipe_tpu.utils.images import seeded_image

    payload = encode_bytes(seeded_image(256, 256), quality=90)

    from hipe_tpu.runtime.serve import ServingPipeline

    serve = ServingPipeline("chain", decode_on_device=True,
                            encode_on_device=True)
    host = ServingPipeline("chain")

    batches = [[payload] * batch_size
               for _ in range(-(-num_images // batch_size))]
    outputs = [b for batch in serve.run(batches) for b in batch]

    # Prove byte-identity against the pure host codec path.
    want = host.process_batch([payload])[0]
    assert all(o == want for o in outputs), "device transcode diverged"

    s = serve.stats
    print(f"{s.images} images transcoded, byte-identical to host codec")
    print(f"wall {s.wall_ms:.0f} ms ({s.img_per_s:.0f} img/s); "
          f"entropy decode {s.decode_ms:.0f} ms, device {s.device_ms:.0f} ms, "
          f"entropy encode {s.encode_ms:.0f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Host seconds of the port's TIFF codec (ark_tpu_torch/io/tiff.py) per 1024² page.

    python scripts/port_tiff_codec_speed.py [--reps 15]

Prints the median, least and most seconds of `--reps` runs of: ``encode`` and ``decode`` of an
uncompressed float32 page (the layout the port writes), ``decode`` of
uint16 pages of Poisson counts (mean 3) compressed as LZW (5), PackBits
(32773) and deflate (8) with and without predictor 2, which PIL's writer
makes here when PIL is installed (those rows are skipped without it), and
the machine's CPU model. The codec is host code: these are CPU times.
"""

from __future__ import annotations

import argparse
import io
import os
import platform
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ark_tpu_torch.io import tiff  # noqa: E402


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def spread(fn, reps) -> str:
    """'median s (least-most, reps)' of `reps` timed calls of fn."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return (f"{np.median(times):.4f} s per page ({min(times):.4f}-{max(times):.4f} "
            f"over {reps} runs)")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=15)
    reps = p.parse_args().reps
    rng = np.random.default_rng(0)
    page = rng.gamma(1.0, 3.0, (1024, 1024)).astype(np.float32)
    raw = tiff.encode(page)
    print(f"cpu: {cpu_model()}")
    print(f"float32 raw encode: {spread(lambda: tiff.encode(page), reps)}")
    print(f"float32 raw decode: {spread(lambda: tiff.decode(raw), reps)}")
    try:
        from PIL import Image
    except ImportError:
        print("PIL absent: no LZW, PackBits or deflate pages to decode")
        return 0
    counts = rng.poisson(3.0, (1024, 1024)).astype(np.uint16)
    for name, compression in (("LZW", "tiff_lzw"), ("PackBits", "packbits"),
                              ("deflate", "tiff_adobe_deflate")):
        for predictor in ((False, True) if name != "PackBits" else (False,)):
            buf = io.BytesIO()
            Image.fromarray(counts).save(buf, format="TIFF", compression=compression,
                                         tiffinfo={317: 2} if predictor else {})
            data = buf.getvalue()
            assert np.array_equal(tiff.decode(data), counts)
            label = f"{name}{' + predictor 2' if predictor else ''}"
            print(f"uint16 {label} decode: {spread(lambda: tiff.decode(data), reps)}; "
                  f"{len(data) / counts.nbytes:.2f} of raw")
    return 0


if __name__ == "__main__":
    sys.exit(main())

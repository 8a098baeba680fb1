"""Write the UCI tables that scikit-learn ships into
``fedml_tpu_torch/data/bundled/sklearn_bundled.npz``.

The port reads ``digits``, ``wine`` and ``breast_cancer`` from that file
(``fedml_tpu_torch/data/acquire.py``) because the machines it runs on need
not have scikit-learn. This script copies the tables out of an installed
scikit-learn (no network) and stores them raw:

* ``digits``: the UCI "Optical Recognition of Handwritten Digits" set
  (1,797 images of 8x8 pixels, values 0-16) as ``uint8``;
* ``wine``: the UCI "Wine" set (178 x 13) as ``float32``;
* ``breast_cancer``: the UCI "Breast Cancer Wisconsin (Diagnostic)" set
  (569 x 30) as ``float32``;

each with its ``int64`` targets, under ``<name>_x`` / ``<name>_y``. The
three sets are licensed CC BY 4.0 by the UCI Machine Learning Repository.
The loader's transforms (digits to 0-255 images, z-scored features, the
80/20 split) are applied when the file is read, as the JAX package's
recipe applies them to scikit-learn's arrays; the float32 cast of the
features is the recipe's first step, so storing them as float32 loses
nothing.

Run from the root of a checkout: ``python scripts/export_sklearn_bundled.py``
(``--check`` compares the committed file with a fresh export instead).
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

OUT = os.path.join("fedml_tpu_torch", "data", "bundled",
                   "sklearn_bundled.npz")


def export() -> dict:
    """The arrays the file holds, from the installed scikit-learn."""
    from sklearn import datasets as skd

    out = {}
    for name, loader in (("digits", skd.load_digits),
                         ("wine", skd.load_wine),
                         ("breast_cancer", skd.load_breast_cancer)):
        ds = loader()
        x = np.asarray(ds.data)
        if name == "digits":
            if not (np.all(x == np.round(x)) and x.min() >= 0
                    and x.max() <= 16):
                raise ValueError("digits pixels are not integers 0-16")
            x = x.astype(np.uint8)
        else:
            x = x.astype(np.float32)
        out[f"{name}_x"] = x
        out[f"{name}_y"] = np.asarray(ds.target, np.int64)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare the committed file with a fresh export")
    a = ap.parse_args(argv)
    arrays = export()
    if a.check:
        with np.load(OUT) as z:
            same = (sorted(z.files) == sorted(arrays) and all(
                z[k].dtype == v.dtype and np.array_equal(z[k], v)
                for k, v in arrays.items()))
        print("equal" if same else "DIFFERENT")
        return 0 if same else 1
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT}: {len(buf.getvalue())} bytes, "
          + ", ".join(f"{k} {v.shape} {v.dtype}" for k, v in arrays.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

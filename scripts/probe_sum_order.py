"""Does a PyTorch row sum on the card depend on how many rows it sums?

    python3 scripts/probe_sum_order.py

For float32 matrices x of 512 rows and L columns, counts the rows of
``x[:B].sum(1)`` that differ bitwise from the same rows of
``x.sum(1)``, for several B and L, and the same for
``ops/precision.py::row_sums`` (the port's fixed-order sum, which must
show none).  Needs one CUDA card."""
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from tombo_tpu_torch.ops.precision import row_sums
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))
    rng = np.random.default_rng(0)
    out = {}
    for L in (1024, 4096, 16384):
        x = torch.tensor(np.abs(rng.normal(0, 1, (512, L))).astype(
            np.float32), device="cuda")
        full, full_rs = x.sum(1), row_sums(x)
        for B in (1, 2, 4, 8, 9, 15, 16, 17, 64, 256):
            n = int((x[:B].sum(1) != full[:B]).sum())
            n_rs = int((row_sums(x[:B]) != full_rs[:B]).sum())
            out["L %d, B %d" % (L, B)] = {"sum(1)": n, "row_sums": n_rs}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""The port's float32 RNA lane against three references, on the CPU.

    python3 scripts/rna_f32_lanes.py

Runs tests/test_torch_rna.py's reads (the recipe of
tests/test_batch_parity.py::test_batch_rna, two reads with a stall and
one that stall removal sends to the static band) through the JAX
package's batch lane at float64 and float32 and through the port at
float64 and float32, and prints, per read, how far the port's float32
result lies from each: start difference (samples), fraction of
boundaries equal where they lie in the raw signal, score difference,
shift and scale difference relative to the scale.  The JAX float32 lane
sums squared raw values in float32, so its changepoints stray further
(ROADMAP.md, Queue 3)."""
import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tombo_tpu import config as j_config  # noqa: E402
from tombo_tpu.pipeline.batch import BatchedResquiggler as JBatched  # noqa
from test_torch_rna import _port, _rna_reads, _t_model  # noqa: E402
from test_torch_batch import _convert  # noqa: E402


def compare(ref, out):
    rows = []
    for (a, ea), (b, eb) in zip(ref, out):
        if a is None or b is None:
            rows.append({"errors": [ea, eb]})
            continue
        sc = a.scale_values.scale
        rows.append({
            "start": int(b.read_start_rel_to_raw - a.read_start_rel_to_raw),
            "segs_equal": float(np.mean(
                a.read_start_rel_to_raw + a.segs ==
                b.read_start_rel_to_raw + b.segs)),
            "score": abs(a.sig_match_score - b.sig_match_score),
            "shift": abs(a.scale_values.shift - b.scale_values.shift) / sc,
            "scale": abs(b.scale_values.scale - sc) / sc})
    return rows


def main():
    model, params, sst, maps, _ = _rna_reads()
    t_params, t_maps = _convert(params, maps)
    t_model = _t_model(model)
    refs = {
        "jax_f64": JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                            dtype=jnp.float64).resquiggle_batch(maps),
        "jax_f32": JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                            dtype=jnp.float32).resquiggle_batch(maps),
        "port_f64": _port(t_model, t_params,
                          "float64").resquiggle_batch(t_maps)}
    t32 = _port(t_model, t_params, "float32").resquiggle_batch(t_maps)
    for name, ref in refs.items():
        print(name, json.dumps(compare(ref, t32)))


if __name__ == "__main__":
    main()

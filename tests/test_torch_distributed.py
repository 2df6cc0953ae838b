"""The port's host-sharding and merge helpers
(``tombo_tpu_torch/parallel/distributed.py``) against the JAX package's:
the same read -> host assignment, and ``psum_hosts`` over a two-process
gloo group equal to numpy's sum in every process."""
import json
import os
import socket
import subprocess
import sys
import textwrap
import types

import numpy as np

from tombo_tpu.parallel import distributed as j_dist
from tombo_tpu_torch.parallel import distributed as t_dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_read_shard_and_key_match_jax():
    rng = np.random.default_rng(0)
    keys = ["%032x" % rng.integers(0, 2 ** 63) + ("-%d" % i)
            for i in range(1000)]
    for n_hosts in range(1, 9):
        t = [t_dist.read_shard(k, n_hosts) for k in keys]
        assert t == [j_dist.read_shard(k, n_hosts) for k in keys]
        if n_hosts > 1:
            assert set(t) == set(range(n_hosts))
    for rec in (types.SimpleNamespace(read_id="r1", fn="a.fast5", start=5),
                types.SimpleNamespace(read_id="", fn="a.fast5", start=5),
                types.SimpleNamespace(read_id=None, fn="b.fast5", start=0),
                types.SimpleNamespace()):
        assert t_dist.read_key(rec) == j_dist.read_key(rec)


def test_dist_context_matches_jax():
    for n_hosts in (1, 3, 5):
        for host in range(n_hosts):
            t = t_dist.DistContext(n_hosts, host)
            j = j_dist.DistContext(n_hosts, host)
            assert t.is_main == j.is_main
            for k in ("read_a", "read_b", "x:12", "0f3a"):
                assert t.owns_read(k) == j.owns_read(k)
            for r in range(12):
                assert t.owns_region(r) == j.owns_region(r)


def test_single_host_is_a_no_op():
    ctx = t_dist.init_distributed()
    assert ctx == t_dist.DistContext(1, 0)
    assert t_dist.init_distributed("localhost:1", 1, 0) == ctx
    a, b = np.arange(5, dtype=np.int32), np.ones(3, np.float32)
    out = t_dist.psum_hosts(ctx, a, b)
    assert out[0] is a and out[1] is b


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch.distributed
    from tombo_tpu_torch.parallel import distributed as d
    port, rank = int(sys.argv[1]), int(sys.argv[2])
    ctx = d.init_distributed("127.0.0.1:%d" % port, 2, rank)
    rng = np.random.default_rng(rank)
    ints = rng.integers(0, 10 ** 6, (3, 5))
    f32 = rng.normal(0, 1, 7).astype(np.float32)
    tot_i, tot_f = d.psum_hosts(ctx, ints, f32)
    torch.distributed.destroy_process_group()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "tombo_tpu"))
    print(json.dumps({"ctx": [ctx.n_hosts, ctx.host_id], "bad": bad,
                      "ints": tot_i.tolist(), "int_dtype": str(tot_i.dtype),
                      "f32": tot_f.tolist(), "f32_dtype": str(tot_f.dtype)}))
""")


def test_psum_hosts_two_gloo_processes():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(port), str(rank)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    parts = [np.random.default_rng(rank) for rank in range(2)]
    ints = [r.integers(0, 10 ** 6, (3, 5)) for r in parts]
    f32 = [r.normal(0, 1, 7).astype(np.float32) for r in parts]
    for rank, got in enumerate(outs):
        assert got["ctx"] == [2, rank] and got["bad"] == []
        assert got["int_dtype"] == "int64" and got["f32_dtype"] == "float32"
        np.testing.assert_array_equal(got["ints"], np.sum(ints, axis=0))
        np.testing.assert_array_equal(np.array(got["f32"], np.float32),
                                      np.sum(np.stack(f32), axis=0))

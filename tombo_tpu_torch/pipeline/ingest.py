"""Process-parallel FAST5 ingest and mapping (copy of
``tombo_tpu/pipeline/ingest.py``).

h5py serializes every HDF5 call behind one process-wide lock, so threads
add contention rather than parallelism on FAST5 ingest; here it runs in
spawned worker processes (reference analog: the N-process x M-thread
fan-out, tombo/resquiggle.py:1612-1656).  Each worker prepares, reads
and maps whole files (``runner.load_and_map``) and sends the mapped reads
back over a queue, the raw signal as int16 DAC values where it is
integral.  Chunks of files come back in the order they were handed out,
so a run's batches do not depend on the workers' timing.

A worker never touches the card: it is started with
``CUDA_VISIBLE_DEVICES`` empty (:func:`start_hidden`), before it imports
anything, and calls no ``torch.cuda`` function.  The pool is
process-wide and reused across runs with the same configuration.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import List, Optional

import numpy as np

_ENV_LOCK = threading.Lock()


@contextlib.contextmanager
def _card_hidden():
    """``CUDA_VISIBLE_DEVICES`` empty for the duration of the block, so a
    process spawned in it sees no card from its first instruction."""
    with _ENV_LOCK:
        old = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            yield
        finally:
            if old is None:
                del os.environ["CUDA_VISIBLE_DEVICES"]
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = old


def start_hidden(procs) -> None:
    """Start spawned processes that see no card."""
    with _card_hidden():
        for p in procs:
            p.start()


def aligner_spec(aligner):
    """A picklable recipe to rebuild ``aligner`` in a worker process, or
    None when the engine cannot cross a process boundary."""
    from .aligner import ExactAligner, MappyAligner, MinimizerAligner
    if isinstance(aligner, MappyAligner):
        return ("mappy", aligner.reference_fn, aligner.preset)
    if isinstance(aligner, MinimizerAligner):
        return ("minimizer", aligner.fasta)
    if isinstance(aligner, ExactAligner):
        return ("exact", aligner.fasta, aligner.seed_len)
    return None


def build_aligner(spec):
    from .aligner import ExactAligner, MappyAligner, MinimizerAligner
    if spec[0] == "mappy":
        return MappyAligner(spec[1], spec[2])
    if spec[0] == "minimizer":
        return MinimizerAligner(spec[1])
    return ExactAligner(spec[1], spec[2])


def _int16_wire(mr):
    """The mapped read with its raw signal as int16 when that is exact
    (FAST5 raw is int16 DAC values; the RNA flip keeps them integral)."""
    rs = mr.raw_signal
    if rs is not None and rs.dtype != np.int16 and rs.size and \
            np.abs(rs).max() < 2 ** 15 and np.all(rs == np.trunc(rs)):
        return mr.replace(raw_signal=np.ascontiguousarray(
            rs.astype(np.int16)))
    return mr


def _worker_main(in_q, out_q, spec, std_ref, seq_samp_type, rsqgl_params,
                 rc):
    from . import runner as rn
    aligner = build_aligner(spec)
    source = rn.Fast5Reads()
    while True:
        job = in_q.get()
        if job is None:
            break
        chunk_id, fns = job
        units = []
        for fn in fns:
            units.extend(
                (f, sg, None if mr is None else _int16_wire(mr), err)
                for f, sg, mr, err in rn.load_and_map(
                    fn, source, aligner, std_ref, seq_samp_type, rc,
                    rsqgl_params))
        out_q.put((chunk_id, units))


class IngestPool:
    """Spawned FAST5 ingest workers (file -> mapped-read units)."""

    CHUNK = 16

    def __init__(self, n: int, spec, std_ref, seq_samp_type, rsqgl_params,
                 rc):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.in_q = ctx.Queue()
        self.out_q = ctx.Queue(maxsize=64)
        self.procs = [
            ctx.Process(target=_worker_main,
                        args=(self.in_q, self.out_q, spec, std_ref,
                              seq_samp_type, rsqgl_params, rc),
                        daemon=True)
            for _ in range(n)]
        start_hidden(self.procs)

    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def run(self, fns: List[str]):
        """Yield the mapped-unit list of each chunk of ``fns``, in file
        order (a chunk that finishes early waits for the ones before
        it)."""
        chunks = [fns[i:i + self.CHUNK]
                  for i in range(0, len(fns), self.CHUNK)]
        for cid, chunk in enumerate(chunks):
            self.in_q.put((cid, chunk))
        done, nxt = {}, 0
        while nxt < len(chunks):
            try:
                cid, units = self.out_q.get(timeout=5.0)
            except Exception:  # noqa: BLE001 — queue.Empty: health check
                if not self.alive():
                    raise RuntimeError("ingest worker died")
                continue
            done[cid] = units
            while nxt in done:
                yield done.pop(nxt)
                nxt += 1

    def shutdown(self):
        for _ in self.procs:
            self.in_q.put(None)
        for p in self.procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join()


_POOL: Optional[IngestPool] = None
_POOL_KEY = None


def _ingest_rc(rc):
    """The run options a worker reads, in a fresh RunConfig (no mesh, no
    process group, nothing on the card)."""
    from .runner import RunConfig
    return RunConfig(
        corrected_group=rc.corrected_group,
        basecall_group=rc.basecall_group,
        basecall_subgroups=tuple(rc.basecall_subgroups),
        overwrite=rc.overwrite, dry_run=rc.dry_run,
        q_score_thresh=rc.q_score_thresh,
        signal_length_range=rc.signal_length_range,
        sequence_length_range=rc.sequence_length_range)


def get_ingest_pool(n: int, aligner, std_ref, seq_samp_type, rsqgl_params,
                    rc) -> Optional[IngestPool]:
    """The process-wide ingest pool, rebuilt only when the configuration
    changes; None when the aligner cannot cross a process boundary."""
    global _POOL, _POOL_KEY
    spec = aligner_spec(aligner)
    if spec is None:
        return None
    wrc = _ingest_rc(rc)
    key = (n, id(aligner), id(std_ref), repr(rsqgl_params),
           repr(seq_samp_type), repr(wrc))
    if _POOL is not None and _POOL_KEY == key and _POOL.alive():
        return _POOL
    shutdown_pool()
    _POOL = IngestPool(n, spec, std_ref, seq_samp_type, rsqgl_params, wrc)
    _POOL_KEY = key
    return _POOL


def shutdown_pool():
    global _POOL, _POOL_KEY
    if _POOL is not None:
        _POOL.shutdown()
    _POOL = _POOL_KEY = None

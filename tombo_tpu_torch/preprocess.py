"""Pre-processing: raw FAST5 files annotated with basecalls from FASTQ
files (copy of ``tombo_tpu/preprocess.py``; reference:
tombo/_preprocess.py:87-533 ``annotate_reads_with_fastq``).

FASTQ records are matched to raw FAST5 files by read id, through a
sequencing summary where one is given (a read id -> file name table) or
else by reading each file's read id, and each record is written to
``/Analyses/<basecall group>/<basecall subgroup>/Fastq``, where the
re-squiggle command reads its basecalls.  Host only; ``h5py`` is imported
inside the functions that open a FAST5 file."""
from __future__ import annotations

import io
import multiprocessing
import os
import zlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

from .errors import TomboError
from .io import fast5 as f5io


def iter_fastq_records(fastq_fns: List[str]) -> Iterator[Tuple[str, str]]:
    """(read id, four-line record) of every record of the FASTQ files
    (reference: tombo/_preprocess.py:143-186); an incomplete or malformed
    record raises."""
    for fastq_fn in fastq_fns:
        with io.open(fastq_fn) as fp:
            while True:
                header = fp.readline()
                if not header:
                    break
                seq = fp.readline()
                plus = fp.readline()
                qual = fp.readline()
                if not qual:
                    raise TomboError(
                        "Successfully parsed " + fastq_fn +
                        " before incomplete record")
                if not header.startswith("@") or not plus.startswith("+"):
                    raise TomboError(
                        "Invalid FASTQ record in " + fastq_fn)
                yield header[1:].split()[0], header + seq + plus + qual


def parse_sequencing_summary(seq_summary_fns: List[str]) -> Dict[str, str]:
    """{read id: FAST5 file name} from tab-separated sequencing summary
    files with ``filename`` and ``read_id`` columns (reference:
    tombo/_preprocess.py:452-501)."""
    out: Dict[str, str] = {}
    for fn in seq_summary_fns:
        with io.open(fn) as fp:
            header = fp.readline().rstrip().split("\t")
            try:
                fn_i = header.index("filename")
                id_i = header.index("read_id")
            except ValueError:
                raise TomboError(
                    "Sequencing summary file missing filename or read_id "
                    "field: " + fn)
            for line in fp:
                rec = line.rstrip().split("\t")
                out[rec[id_i]] = rec[fn_i]
    return out


def index_fast5s_by_read_id(fast5s_dir: str,
                            num_threads: int = 8) -> Dict[str, str]:
    """{read id: path} of the FAST5 files under a directory (reference:
    tombo/_preprocess.py:87-140); unreadable files are left out."""
    import h5py

    def one(fn):
        try:
            with h5py.File(fn, "r") as fp:
                return f5io.get_read_id(fp), fn
        except (OSError, TomboError):
            return None

    with ThreadPoolExecutor(num_threads) as pool:
        return dict(r for r in pool.map(
            one, list(f5io.iter_fast5_reads(fast5s_dir))) if r is not None)


def annotate_reads_with_fastq(
        fast5s_dir: str, fastq_fns: List[str],
        seq_summary_fns: Optional[List[str]] = None,
        basecall_group: str = "Basecall_1D_000",
        basecall_subgroup: str = "BaseCalled_template",
        overwrite: bool = False, num_threads: int = 8,
        min_parallel_records: int = 200) -> Tuple[int, int]:
    """Write the FASTQ records into their raw FAST5 files; returns (records
    written, records not written: no file with the read id, or a Fastq
    slot already there without ``overwrite``, or an unwritable file).
    From ``min_parallel_records`` records on, ``num_threads`` spawned
    processes write, each a disjoint set of files (HDF5 writes hold a
    process-wide lock, so threads would not overlap them)."""
    if seq_summary_fns:
        id_to_path = {
            rid: os.path.join(fast5s_dir, fn) for rid, fn in
            parse_sequencing_summary(seq_summary_fns).items()
            if os.path.isfile(os.path.join(fast5s_dir, fn))}
    else:
        id_to_path = index_fast5s_by_read_id(fast5s_dir, num_threads)
    n_miss = 0
    jobs: List[Tuple[str, str]] = []
    for read_id, record in iter_fastq_records(fastq_fns):
        path = id_to_path.get(read_id)
        if path is None:
            n_miss += 1
        else:
            jobs.append((path, record))
    shard_args = [(jobs, basecall_group, basecall_subgroup, overwrite)]
    if num_threads > 1 and len(jobs) >= min_parallel_records:
        shards: List[List[Tuple[str, str]]] = [[] for _ in range(num_threads)]
        for path, record in jobs:
            shards[zlib.crc32(path.encode()) % num_threads].append(
                (path, record))
        shard_args = [(shard, basecall_group, basecall_subgroup, overwrite)
                      for shard in shards if shard]
        with ProcessPoolExecutor(
                max_workers=num_threads,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            outs = list(pool.map(_annotate_shard, shard_args))
    else:
        outs = [_annotate_shard(a) for a in shard_args]
    return (sum(a for a, _ in outs), n_miss + sum(m for _, m in outs))


def _annotate_shard(args: Tuple) -> Tuple[int, int]:
    """Write one shard of (FAST5 path, FASTQ record) jobs: (written, not
    written)."""
    jobs, basecall_group, basecall_subgroup, overwrite = args
    n_ann = n_miss = 0
    for path, record in jobs:
        try:
            ok = f5io.write_fastq(path, record, basecall_group,
                                  basecall_subgroup, overwrite)
        except OSError:
            ok = False
        n_ann += ok
        n_miss += not ok
    return n_ann, n_miss

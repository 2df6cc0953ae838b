"""``tombo-tpu-torch`` command line: the port's counterpart of
``tombo_tpu/cli/main.py``.

The same command tree and option names as the JAX package's (reference:
tombo/__main__.py:22-147, tombo/_option_parsers.py) for the commands the
port has: ``resquiggle``, ``preprocess annotate_raw_with_fastqs``,
``filter`` (``clear_filters``, ``genome_locations``,
``raw_signal_matching``, ``q_score``, ``level_coverage``, ``stuck``),
``detect_modifications`` (``de_novo``, ``alternative_model``,
``model_sample_compare``, ``level_sample_compare``,
``aggregate_per_read_stats``), ``text_output`` (``browser_files``,
``signif_sequence_context``), ``build_model`` (``estimate_reference``,
``estimate_alt_reference``, ``estimate_motif_alt_reference``,
``estimate_scale``, ``event_resquiggle``) and ``plot`` (thirteen
plots, ``plot/cli.py``).  The commands that run batched or tensor work
take ``--device`` (default ``cuda``): without a card such a command
fails unless ``--device cpu`` is given; ``preprocess``, ``filter``,
``text_output``, ``build_model event_resquiggle`` and the signal plots
are host only.  ``resquiggle`` and the detection tests
run over several hosts with ``--num-hosts``, ``--host-id`` and
``--coordinator-address`` (gloo).  A run error or a missing card ends
the command with exit code 1 and its message.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from .. import config
from .._version import VERSION
from ..errors import TomboError


# ------------------------------------------------------------ shared opts

def _add_fast5_dirs_arg(p):
    """FAST5 directories as the reference's ``--fast5-basedirs``
    (reference: tombo/_option_parsers.py:88-93) or positionally; merged in
    ``main``."""
    p.add_argument("fast5_basedirs", nargs="*", default=[],
                   help="Directories containing FAST5 files (positional "
                        "alias of --fast5-basedirs).")
    p.add_argument("--fast5-basedirs", dest="fast5_basedirs_opt",
                   nargs="+", help="Directories containing FAST5 files.")


def _add_common(p, device: bool = True):
    p.add_argument("--corrected-group",
                   default=config.DEFAULT_CORRECTED_GROUP,
                   help="FAST5 group created by resquiggle. Default: "
                        "%(default)s")
    p.add_argument("--basecall-subgroups", nargs="+",
                   default=[config.DEFAULT_BASECALL_SUBGROUP],
                   help="FAST5 subgroups with basecalls. Default: "
                        "%(default)s")
    p.add_argument("--processes", type=int, default=4,
                   help="Host worker threads (reading, mapping and "
                        "preparing regions; the re-squiggle and the tests "
                        "run batched on the device). Default: "
                        "%(default)d")
    p.add_argument("--quiet", "-q", action="store_true")
    if device:
        _add_device(p)


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help='Device of the batched work: "cuda" (the card, '
                        'the default) or "cpu" (the plain PyTorch '
                        "versions).")


def _add_multihost(p):
    p.add_argument("--num-hosts", type=int, default=1,
                   help="Total hosts in a multi-host run. Default: "
                        "%(default)d")
    p.add_argument("--host-id", type=int, default=None,
                   help="This host's rank in [0, num-hosts).")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of the rank-0 process (gloo "
                        "rendezvous).")


def _dist_from_args(args):
    if getattr(args, "num_hosts", 1) <= 1:
        return None
    from ..parallel.distributed import init_distributed
    return init_distributed(args.coordinator_address, args.num_hosts,
                            args.host_id, device=args.device)


def _open_genomic_aligner(args):
    """mappy, then the native minimizer engine; the exact aligner only
    behind ``--allow-exact-aligner`` (reference: tombo/resquiggle.py:14-21
    fails without mappy)."""
    from ..io.fasta import Fasta
    from ..pipeline.aligner import (ExactAligner, MappyAligner,
                                    MinimizerAligner)
    try:
        return MappyAligner(args.reference)
    except TomboError:
        pass
    fasta = Fasta.read(args.reference)
    try:
        return MinimizerAligner(fasta)
    except TomboError as e:
        if not args.allow_exact_aligner:
            raise TomboError(
                "no real aligner available: mappy is not installed and "
                "the native minimizer aligner could not be loaded (%s). "
                "The built-in exact aligner fails to map real error-prone "
                "reads; pass --allow-exact-aligner to use it anyway "
                "(synthetic or error-free reads only)." % e)
        print("WARNING: no real aligner available; using the built-in "
              "exact aligner. Real error-prone reads will fail to map.",
              file=sys.stderr)
        return ExactAligner(fasta)


def _reads_index(dirs, args):
    from ..io.index import ReadsIndex
    return ReadsIndex(dirs, args.corrected_group,
                      getattr(args, "basecall_subgroups", None))


def _samp_type(args) -> str:
    return config.RNA_SAMP_TYPE if args.rna else config.DNA_SAMP_TYPE


def _std_ref(args, samp_type):
    from ..io.model_io import KmerModel
    if args.tombo_model_filename:
        return KmerModel.load(args.tombo_model_filename)
    return KmerModel.load_default(samp_type)


# ------------------------------------------------------------- resquiggle

_RESQUIGGLE_ADVANCED = [
    "--tombo-model-filename", "--signal-align-parameters",
    "--segmentation-parameters", "--skip-sequence-rescaling",
    "--max-scaling-iterations", "--signal-length-range",
    "--sequence-length-range", "--fit-global-scale", "--fixed-scale",
    "--outlier-threshold", "--skip-index", "--include-event-stdev",
    "--ignore-read-locks", "--threads-per-process", "--batch-size",
    "--num-hosts", "--host-id", "--coordinator-address", "--profile",
    "--trace-dir",
]


def _print_advanced_resquiggle(parser):
    """--print-advanced-arguments (reference:
    tombo/_option_parsers.py:438,785-806)."""
    print("Advanced re-squiggle arguments:")
    for act in parser._actions:
        if any(opt in _RESQUIGGLE_ADVANCED for opt in act.option_strings):
            print("  %-28s %s" % (", ".join(act.option_strings),
                                  act.help or ""))


def _detect_samp_type(args) -> str:
    """From the flags, else the first readable FAST5 (reference:
    tombo/tombo_helper.py:872-965)."""
    if args.rna:
        return config.RNA_SAMP_TYPE
    if args.dna:
        return config.DNA_SAMP_TYPE
    import h5py
    from ..io import fast5 as f5io
    for fn in f5io.iter_fast5_reads(args.fast5_basedir):
        try:
            with h5py.File(fn, "r") as fp:
                return (config.RNA_SAMP_TYPE if f5io.is_read_rna(fp)
                        else config.DNA_SAMP_TYPE)
        except (OSError, TomboError):
            continue
    raise TomboError("No readable FAST5 files found.")


def _resquiggle_main(args):
    from ..filters import parse_obs_filter
    from ..pipeline.runner import RunConfig, resquiggle_all_reads
    from ..types import SeqSampleType

    if args.print_advanced_arguments:
        _print_advanced_resquiggle(args._parser)
        return 0
    samp_type = _detect_samp_type(args)
    sst = SeqSampleType(samp_type, samp_type == config.RNA_SAMP_TYPE)
    std_ref = _std_ref(args, samp_type)
    aligner = _open_genomic_aligner(args)

    params = config.load_resquiggle_parameters(samp_type)
    if args.signal_align_parameters:
        sap = args.signal_align_parameters
        params = params.replace(
            match_evalue=sap[0], skip_pen=sap[1], bandwidth=int(sap[2]))
    if args.segmentation_parameters:
        sp = args.segmentation_parameters
        params = params.replace(
            running_stat_width=int(sp[0]), min_obs_per_base=int(sp[1]),
            mean_obs_per_event=int(sp[3]) if len(sp) > 3 else
            params.mean_obs_per_event)

    rc = RunConfig(
        corrected_group=args.corrected_group,
        basecall_group=args.basecall_group,
        basecall_subgroups=tuple(args.basecall_subgroups),
        overwrite=args.overwrite,
        ignore_read_locks=args.ignore_read_locks,
        q_score_thresh=args.q_score or 0.0,
        signal_length_range=tuple(args.signal_length_range)
        if args.signal_length_range else None,
        sequence_length_range=tuple(args.sequence_length_range)
        if args.sequence_length_range else None,
        sig_match_thresh=args.signal_matching_score,
        skip_index=args.skip_index,
        progress=not args.quiet,
        compute_sd=args.include_event_stdev,
        num_io_threads=args.processes * args.threads_per_process,
        batch_size=args.batch_size,
        device=args.device,
        dist=_dist_from_args(args),
        obs_filter=parse_obs_filter(args.obs_per_base_filter) or None,
        max_scaling_iters=args.max_scaling_iterations,
        skip_seq_rescaling=args.skip_sequence_rescaling,
        fit_global_scale=args.fit_global_scale,
        const_scale=args.fixed_scale,
        outlier_thresh=(args.outlier_threshold
                        if args.outlier_threshold is not None and
                        args.outlier_threshold > 0 else None),
        failed_reads_fn=args.failed_reads_filename,
        num_most_common_errors=args.num_most_common_errors,
        profile=args.profile, trace_dir=args.trace_dir)
    summary, _ = resquiggle_all_reads(
        args.fast5_basedir, aligner, std_ref, sst, params, rc)
    if not args.quiet:
        print("Re-squiggle complete: %d succeeded, %d failed" %
              (summary.n_success, summary.n_failed))
        for mode, cnt in summary.failure_modes.most_common(10):
            print("  %5d : %s" % (cnt, mode))
    return 0


def _add_resquiggle_parser(subparsers):
    p = subparsers.add_parser(
        "resquiggle", help="Re-annotate raw signal with genomic alignment "
        "from existing basecalls.")
    p.add_argument("fast5_basedir",
                   help="Directory containing raw FAST5 files.")
    p.add_argument("reference",
                   help="Reference genome/transcriptome FASTA.")
    p.add_argument("--basecall-group",
                   default=config.DEFAULT_BASECALL_GROUP)
    p.add_argument("--dna", action="store_true",
                   help="Force DNA sample type.")
    p.add_argument("--rna", action="store_true",
                   help="Force RNA sample type.")
    p.add_argument("--tombo-model-filename")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--ignore-read-locks", action="store_true")
    p.add_argument("--q-score", type=float)
    p.add_argument("--signal-matching-score", type=float)
    p.add_argument("--signal-length-range", type=int, nargs=2)
    p.add_argument("--sequence-length-range", type=int, nargs=2)
    p.add_argument("--signal-align-parameters", type=float, nargs="+")
    p.add_argument("--segmentation-parameters", type=int, nargs="+")
    p.add_argument("--include-event-stdev", action="store_true")
    p.add_argument("--allow-exact-aligner", action="store_true",
                   help="Permit the built-in exact aligner when no real "
                        "aligner is available (synthetic or error-free "
                        "reads only).")
    p.add_argument("--skip-index", action="store_true")
    p.add_argument("--threads-per-process", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--obs-per-base-filter", nargs="+", default=[],
                   help='Observations-per-base percentile filters, e.g. '
                        '"99:200 100:5000".')
    p.add_argument("--max-scaling-iterations", type=int,
                   default=config.MAX_SCALING_ITERS,
                   help="Maximum re-squiggle scale re-fit iterations. "
                        "Default: %(default)d")
    p.add_argument("--skip-sequence-rescaling", action="store_true",
                   help="Skip the sequence-fitted (Theil-Sen) re-scaling.")
    p.add_argument("--fit-global-scale", action="store_true",
                   help="Fit one global scale parameter from a read subset "
                        "instead of per-read scales.")
    p.add_argument("--fixed-scale", type=float,
                   help="Fixed constant scale value (advanced).")
    p.add_argument("--outlier-threshold", type=float,
                   default=config.OUTLIER_THRESH,
                   help="Windsorize the signal at this number of scale "
                        "values. Negative disables. Default: %(default)f")
    p.add_argument("--failed-reads-filename",
                   help="Write failed read filenames with errors here.")
    p.add_argument("--num-most-common-errors", type=int, default=0,
                   help="Show this many most common errors during the run.")
    p.add_argument("--print-advanced-arguments", action="store_true",
                   help="Print advanced re-squiggle arguments and exit.")
    p.add_argument("--profile", action="store_true",
                   help="Print where the run's time went at its end, on "
                        "stderr: seconds by re-squiggle stage, the waits "
                        "for device results, mapping and writeback, and "
                        "the bytes sent to and fetched from the device.")
    p.add_argument("--trace-dir", metavar="DIR",
                   help="Write a torch.profiler trace of the re-squiggle "
                        "batches (host calls, and the card's kernels on a "
                        "card; each stage a named range) into DIR as "
                        "Chrome trace JSON.")
    _add_common(p)
    _add_multihost(p)
    p.set_defaults(func=_resquiggle_main, _parser=p)


# ------------------------------------------------------------- preprocess

def _annotate_fastqs_main(args):
    from ..preprocess import annotate_reads_with_fastq
    total_ann = total_miss = 0
    for fast5s_dir in args.fast5_basedir:
        n_ann, n_miss = annotate_reads_with_fastq(
            fast5s_dir, args.fastq_filenames,
            args.sequencing_summary_filenames, args.basecall_group,
            args.basecall_subgroup, args.overwrite, args.processes)
        total_ann += n_ann
        total_miss += n_miss
    if not args.quiet:
        print("Annotated %d reads (%d FASTQ records unmatched)" %
              (total_ann, total_miss))
    return 0


def _add_preprocess_parsers(subparsers):
    grp = subparsers.add_parser(
        "preprocess", help="Pre-process nanopore reads for processing.")
    sub = grp.add_subparsers(dest="subcommand", required=True)
    p = sub.add_parser("annotate_raw_with_fastqs",
                       help="Add basecalled sequence from FASTQs to raw "
                            "FAST5s.")
    p.add_argument("--fast5-basedir", dest="fast5_basedir", nargs="+",
                   required=True)
    p.add_argument("--fastq-filenames", nargs="+", required=True)
    p.add_argument("--sequencing-summary-filenames", nargs="+")
    p.add_argument("--basecall-group", default="Basecall_1D_000")
    p.add_argument("--basecall-subgroup", default="BaseCalled_template")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--processes", type=int, default=4)
    p.add_argument("--quiet", "-q", action="store_true")
    p.set_defaults(func=_annotate_fastqs_main)


# ----------------------------------------------------------------- filter

def _add_filter_parsers(subparsers):
    from .. import filters as filt

    grp = subparsers.add_parser(
        "filter", help="Apply filter to Tombo index file.")
    sub = grp.add_subparsers(dest="subcommand", required=True)

    def add(name, help_text, fn, extra=None):
        p = sub.add_parser(name, help=help_text)
        _add_fast5_dirs_arg(p)
        _add_common(p, device=False)
        if extra:
            extra(p)
        p.set_defaults(func=fn)

    def _clear(args):
        for d in args.fast5_basedirs:
            filt.clear_filters(d, args.corrected_group)
        return 0
    add("clear_filters", "Clear filters.", _clear)

    def _gloc(args):
        try:
            regs = filt.parse_genome_regions(args.include_regions)
        except ValueError:
            raise TomboError("Invalid --include-regions: use chrm or "
                             "chrm:start-end")
        for d in args.fast5_basedirs:
            filt.filter_reads_for_genome_pos(
                d, args.corrected_group, regs, args.include_partial_overlap,
                args.quiet)
        return 0
    add("genome_locations", "Filter reads by mapping location.", _gloc,
        lambda p: (p.add_argument("--include-regions", nargs="+",
                                  required=True),
                   p.add_argument("--include-partial-overlap",
                                  action="store_true")))

    def _sigmatch(args):
        for d in args.fast5_basedirs:
            filt.filter_reads_for_signal_matching(
                d, args.corrected_group, args.signal_matching_score,
                args.quiet)
        return 0
    add("raw_signal_matching", "Filter by signal matching score.",
        _sigmatch,
        lambda p: p.add_argument("--signal-matching-score", type=float,
                                 required=True))

    def _qscore(args):
        for d in args.fast5_basedirs:
            filt.filter_reads_for_qscore(
                d, args.basecall_group, args.corrected_group,
                args.q_score, args.quiet)
        return 0
    add("q_score", "Filter by mean q-score.", _qscore,
        lambda p: (p.add_argument("--q-score", type=float, required=True),
                   p.add_argument("--basecall-group",
                                  default=config.DEFAULT_BASECALL_GROUP)))

    def _cov(args):
        for d in args.fast5_basedirs:
            filt.filter_reads_for_coverage(
                d, args.corrected_group, args.percent_to_filter / 100.0,
                args.quiet)
        return 0
    add("level_coverage", "Filter reads for more even coverage.", _cov,
        lambda p: p.add_argument("--percent-to-filter", type=float,
                                 default=10.0))

    def _stuck(args):
        obs = filt.parse_obs_filter(args.obs_per_base_filter)
        for d in args.fast5_basedirs:
            filt.filter_reads_for_stuck(d, args.corrected_group, obs,
                                        args.quiet)
        return 0
    add("stuck", 'Filter reads with more "stuck" bases.', _stuck,
        lambda p: p.add_argument("--obs-per-base-filter", nargs="+",
                                 required=True,
                                 help="pctl:thresh pairs, e.g. 99:200"))


# ------------------------------------------------- detect_modifications

def _add_detect_parsers(subparsers):
    from ..stats import aggregate as agg
    from ..stats import detect as dt
    from ..stats.files import ALT_MODEL_TXT, DE_NOVO_TXT, SAMP_COMP_TXT

    grp = subparsers.add_parser(
        "detect_modifications",
        help="Statistical testing for non-standard nucleotides.")
    sub = grp.add_subparsers(dest="subcommand", required=True)

    def common_test_opts(p):
        _add_fast5_dirs_arg(p)
        p.add_argument("--statistics-file-basename", required=True)
        p.add_argument("--per-read-statistics-basename")
        p.add_argument("--reference", required=True,
                       help="Reference FASTA (for expected levels)")
        p.add_argument("--tombo-model-filename")
        p.add_argument("--fishers-method-context", type=int,
                       default=config.FM_OFFSET_DEFAULT)
        p.add_argument("--minimum-test-reads", type=int, default=1)
        p.add_argument("--single-read-threshold", type=float, nargs="+")
        p.add_argument("--multiprocess-region-size", type=int,
                       default=config.DEFAULT_REGION_SIZE)
        p.add_argument("--num-most-significant-stored", type=int,
                       default=100000)
        p.add_argument("--skip-levels-cache", action="store_true",
                       help="Neither read nor write the per-directory "
                            "read-levels sidecar.")
        p.add_argument("--dna", action="store_true")
        p.add_argument("--rna", action="store_true")
        p.add_argument(
            "--coverage-dampen-counts", type=float, nargs=2,
            metavar=("UNMOD", "MOD"), default=list(config.COV_DAMP_COUNTS),
            help="Dampen fraction modified estimates for low coverage "
                 "sites: unmodified and modified pseudo read counts (a "
                 "beta prior on the fraction estimate). Set to \"0 0\" to "
                 "disable. Default: %(default)s")
        _add_common(p)
        _add_multihost(p)

    def setup(args, stat_type, thresh_table):
        from ..io.fasta import Fasta
        samp_type = _samp_type(args)
        if args.single_read_threshold:
            if len(args.single_read_threshold) == 1:
                lower, upper = None, args.single_read_threshold[0]
            else:
                lower, upper = args.single_read_threshold[:2]
        else:
            lower, upper = thresh_table[samp_type]
        params = dt.TestParams(
            stat_type=stat_type, fm_offset=args.fishers_method_context,
            min_test_reads=args.minimum_test_reads,
            single_read_thresh=upper, lower_thresh=lower,
            region_size=args.multiprocess_region_size,
            num_most_signif=args.num_most_significant_stored,
            cov_damp_counts=tuple(args.coverage_dampen_counts))
        return _std_ref(args, samp_type), Fasta.read(args.reference), params

    def stats_fn_of(args):
        bn = args.statistics_file_basename
        return bn if bn.endswith(".tombo.stats") else bn + ".tombo.stats"

    def pr_fn_of(args):
        bn = args.per_read_statistics_basename
        if bn is None:
            return None
        return (bn if bn.endswith(".tombo.per_read_stats")
                else bn + ".tombo.per_read_stats")

    def run(args, idx, params, **kw):
        dt.test_significance(
            idx, params, stats_fn_of(args), num_processes=args.processes,
            device=args.device, dist=_dist_from_args(args),
            levels_sidecar=not getattr(args, "skip_levels_cache", False),
            **kw)
        return 0

    def _de_novo(args):
        std_ref, fasta, params = setup(args, DE_NOVO_TXT,
                                       config.DE_NOVO_THRESH)
        return run(args, _reads_index(args.fast5_basedirs, args), params,
                   fasta=fasta, std_ref=std_ref, per_read_bn=pr_fn_of(args))
    p = sub.add_parser("de_novo", help="Test against a canonical model.")
    common_test_opts(p)
    p.set_defaults(func=_de_novo)

    def _alt(args):
        from ..io.model_io import load_alt_refs
        std_ref, fasta, params = setup(args, ALT_MODEL_TXT,
                                       config.LLR_THRESH)
        alt_refs = load_alt_refs(args.alternate_bases, _samp_type(args),
                                 args.alternate_model_filenames)
        if not alt_refs:
            raise TomboError("No alternative models successfully loaded.")
        params.use_standard_llhr = args.standard_log_likelihood_ratio
        return run(args, _reads_index(args.fast5_basedirs, args), params,
                   fasta=fasta, std_ref=std_ref, alt_refs=alt_refs,
                   per_read_bn=pr_fn_of(args))
    p = sub.add_parser("alternative_model",
                       help="Test against known non-canonical base "
                            "models.")
    common_test_opts(p)
    p.add_argument("--alternate-bases", nargs="+", default=[])
    p.add_argument("--alternate-model-filenames", nargs="+")
    p.add_argument("--standard-log-likelihood-ratio", action="store_true")
    p.add_argument("--print-available-models", action="store_true",
                   help="Print available alternative models and exit "
                        "(handled before argument validation).")
    p.set_defaults(func=_alt)

    def _samp_comp(args):
        std_ref, fasta, params = setup(args, SAMP_COMP_TXT,
                                       config.SAMP_COMP_THRESH)
        if not args.sample_only_estimates:
            params.prior_weights = tuple(args.model_prior_weights)
        return run(args, _reads_index(args.fast5_basedirs, args), params,
                   fasta=fasta,
                   std_ref=None if args.sample_only_estimates else std_ref,
                   ctrl_reads_index=_reads_index(
                       args.control_fast5_basedirs, args),
                   per_read_bn=pr_fn_of(args))
    p = sub.add_parser("model_sample_compare",
                       help="Test against levels estimated from a "
                            "control sample.")
    common_test_opts(p)
    p.add_argument("--control-fast5-basedirs", nargs="+", required=True)
    p.add_argument("--sample-only-estimates", action="store_true")
    p.add_argument(
        "--model-prior-weights", type=float, nargs=2,
        metavar=("MEAN", "SD"),
        default=[config.MEAN_PRIOR_CONST, config.SD_PRIOR_CONST],
        help="Prior weights (mean, spread) of the canonical model in the "
             "control sample's posterior levels (reference: "
             "tombo/_option_parsers.py:600-604). Default: %(default)s")
    p.set_defaults(func=_samp_comp)

    def _level_comp(args):
        ctrl_dirs = (args.control_fast5_basedirs or
                     args.alternate_fast5_basedirs)
        if not ctrl_dirs:
            raise TomboError(
                "level_sample_compare requires --alternate-fast5-basedirs "
                "(or its alias --control-fast5-basedirs)")
        # the effect-size statistic by default; --store-p-value stores
        # p-values (reference: tombo/tombo_stats.py:4955-4959)
        params = dt.TestParams(
            stat_type=args.statistic_type +
            ("" if args.store_p_value else "_stat"),
            fm_offset=args.fishers_method_context,
            min_test_reads=args.minimum_test_reads,
            region_size=args.multiprocess_region_size,
            num_most_signif=args.num_most_significant_stored)
        return run(args, _reads_index(args.fast5_basedirs, args), params,
                   ctrl_reads_index=_reads_index(ctrl_dirs, args))
    p = sub.add_parser("level_sample_compare",
                       help="Group level tests against a control sample.")
    _add_fast5_dirs_arg(p)
    p.add_argument("--alternate-fast5-basedirs", nargs="+",
                   help="Directories containing FAST5s for the alternate "
                        "(comparison) set of reads (reference: "
                        "tombo/_option_parsers.py:95-98)")
    p.add_argument("--control-fast5-basedirs", nargs="+",
                   help="Alias for --alternate-fast5-basedirs")
    p.add_argument("--statistics-file-basename", required=True)
    p.add_argument("--statistic-type", default="ks",
                   choices=["ks", "u", "t"])
    p.add_argument("--store-p-value", action="store_true",
                   help="Store p-value instead of the effect-size "
                        "statistic (D-statistic for KS, common-language "
                        "effect size deviation for U, Cohen's D for t).")
    p.add_argument("--fishers-method-context", type=int, default=1)
    p.add_argument("--minimum-test-reads", type=int, default=50)
    p.add_argument("--multiprocess-region-size", type=int,
                   default=config.DEFAULT_REGION_SIZE)
    p.add_argument("--num-most-significant-stored", type=int,
                   default=100000)
    p.add_argument("--skip-levels-cache", action="store_true",
                   help="Neither read nor write the per-directory "
                        "read-levels sidecar.")
    _add_common(p)
    _add_multihost(p)
    p.set_defaults(func=_level_comp)

    def _aggregate(args):
        if len(args.single_read_threshold) == 1:
            lower, upper = None, args.single_read_threshold[0]
        else:
            lower, upper = args.single_read_threshold[:2]
        agg.aggregate_per_read_stats(
            args.per_read_statistics_filename,
            args.statistics_file_basename + ".tombo.stats", upper, lower,
            cov_damp_counts=tuple(args.coverage_dampen_counts),
            min_test_reads=args.minimum_test_reads,
            num_most_signif=args.num_most_significant_stored)
        return 0
    p = sub.add_parser("aggregate_per_read_stats",
                       help="Aggregate per-read statistics.")
    p.add_argument(
        "--coverage-dampen-counts", type=float, nargs=2,
        metavar=("UNMOD", "MOD"), default=list(config.COV_DAMP_COUNTS))
    p.add_argument("--per-read-statistics-filename", required=True)
    p.add_argument("--statistics-file-basename", required=True)
    p.add_argument("--single-read-threshold", type=float, nargs="+",
                   required=True)
    p.add_argument("--minimum-test-reads", type=int, default=1)
    p.add_argument("--num-most-significant-stored", type=int,
                   default=100000)
    p.add_argument("--quiet", "-q", action="store_true")
    _add_device(p)
    p.set_defaults(func=_aggregate)


# ------------------------------------------------------------ text_output

def _add_text_output_parsers(subparsers):
    from ..output import text as txt

    grp = subparsers.add_parser(
        "text_output", help="Output results in text files.")
    sub = grp.add_subparsers(dest="subcommand", required=True)

    def _browser(args):
        from ..io.fasta import Fasta
        txt.write_all_browser_files(
            _reads_index(args.fast5_basedirs, args)
            if args.fast5_basedirs else None,
            _reads_index(args.control_fast5_basedirs, args)
            if args.control_fast5_basedirs else None,
            args.statistics_filename, args.browser_file_basename,
            args.file_types, args.motif_descriptions,
            Fasta.read(args.genome_fasta) if args.genome_fasta else None)
        return 0
    p = sub.add_parser("browser_files",
                       help="Write wiggle/bedGraph browser files.")
    p.add_argument("--fast5-basedirs", nargs="+")
    p.add_argument("--control-fast5-basedirs", nargs="+")
    p.add_argument("--statistics-filename")
    p.add_argument("--browser-file-basename", default="tombo_results")
    p.add_argument("--file-types", nargs="+", default=["coverage"],
                   choices=list(txt.ALL_WIG_TYPES))
    p.add_argument("--motif-descriptions", nargs="+")
    p.add_argument("--genome-fasta")
    _add_common(p, device=False)
    p.set_defaults(func=_browser)

    def _signif_seq(args):
        from ..io.fasta import Fasta
        txt.write_most_signif(
            args.statistics_filename, args.sequences_filename,
            args.num_regions, args.num_bases, Fasta.read(args.genome_fasta))
        return 0
    p = sub.add_parser("signif_sequence_context",
                       help="FASTA around most modified sites.")
    p.add_argument("--statistics-filename", required=True)
    p.add_argument("--genome-fasta", required=True)
    p.add_argument("--sequences-filename",
                   default="tombo_results.significant_regions.fasta")
    p.add_argument("--num-regions", type=int, default=100)
    p.add_argument("--num-bases", type=int, default=21)
    p.add_argument("--quiet", "-q", action="store_true")
    p.set_defaults(func=_signif_seq)


# ------------------------------------------------------------ build_model

def _add_build_model_parsers(subparsers):
    grp = subparsers.add_parser(
        "build_model", help="Create canonical and alternative models.")
    sub = grp.add_subparsers(dest="subcommand", required=True)

    def _est_ref(args):
        from ..io.fasta import Fasta
        from ..stats import estimate as est
        model = est.estimate_kmer_model(
            _reads_index(args.fast5_basedirs, args),
            Fasta.read(args.reference), args.minimum_test_reads,
            args.upstream_bases, args.downstream_bases,
            args.minimum_kmer_observations, args.kmer_specific_sd,
            args.coverage_threshold, args.estimate_mean,
            args.multiprocess_region_size, device=args.device)
        model.write_model(args.tombo_model_filename)
        return 0
    p = sub.add_parser("estimate_reference",
                       help="Estimate canonical k-mer model.")
    _add_fast5_dirs_arg(p)
    p.add_argument("--reference", required=True)
    p.add_argument("--tombo-model-filename", required=True)
    p.add_argument("--estimate-mean", action="store_true")
    p.add_argument("--kmer-specific-sd", action="store_true")
    p.add_argument("--upstream-bases", type=int, default=1)
    p.add_argument("--downstream-bases", type=int, default=2)
    p.add_argument("--minimum-test-reads", type=int, default=10)
    p.add_argument("--minimum-kmer-observations", type=int, default=5)
    p.add_argument("--coverage-threshold", type=int)
    p.add_argument("--multiprocess-region-size", type=int,
                   default=config.DEFAULT_REGION_SIZE)
    _add_common(p)
    p.set_defaults(func=_est_ref)

    def _est_alt(args):
        from ..stats import estimate as est
        std_ref = _std_ref(args, _samp_type(args))
        idx = (_reads_index(args.fast5_basedirs, args)
               if args.fast5_basedirs else None)
        ctrl = (_reads_index(args.control_fast5_basedirs, args)
                if args.control_fast5_basedirs else None)
        alt = est.estimate_alt_model(
            idx, ctrl, std_ref, args.alternate_model_base,
            args.alt_fraction_percentile, args.minimum_kmer_observations,
            args.save_density_basename, args.kernel_density_bandwidth,
            args.alternate_density_filename, args.control_density_filename,
            device=args.device)
        alt.name = args.alternate_model_name
        alt.write_model(args.alternate_model_filename)
        return 0
    p = sub.add_parser("estimate_alt_reference",
                       help="Estimate alternative-base model (KDE).")
    p.add_argument("--fast5-basedirs", nargs="+")
    p.add_argument("--control-fast5-basedirs", nargs="+")
    p.add_argument("--alternate-model-filename", required=True)
    p.add_argument("--alternate-model-name", required=True)
    p.add_argument("--alternate-model-base", required=True,
                   choices=["A", "C", "G", "T"])
    p.add_argument("--tombo-model-filename")
    p.add_argument("--dna", action="store_true")
    p.add_argument("--rna", action="store_true")
    p.add_argument("--alt-fraction-percentile", type=float, default=5)
    p.add_argument("--minimum-kmer-observations", type=int, default=1000)
    p.add_argument("--save-density-basename")
    p.add_argument("--alternate-density-filename")
    p.add_argument("--control-density-filename")
    p.add_argument("--kernel-density-bandwidth", type=float, default=0.05)
    _add_common(p)
    p.set_defaults(func=_est_alt)

    def _est_motif_alt(args):
        from ..io.fasta import Fasta
        from ..stats import estimate as est
        valid_poss = None
        if args.valid_locations_filename:
            from ..io.bed import parse_locs_file
            valid_poss = parse_locs_file(args.valid_locations_filename)
        alt = est.estimate_motif_alt_model(
            _reads_index(args.fast5_basedirs, args),
            Fasta.read(args.reference), args.motif_description,
            args.upstream_bases, args.downstream_bases,
            args.minimum_kmer_observations, args.minimum_test_reads,
            args.coverage_threshold, valid_poss=valid_poss,
            region_size=args.multiprocess_region_size, device=args.device)
        alt.name = args.alternate_model_name
        alt.write_model(args.alternate_model_filename)
        return 0
    p = sub.add_parser("estimate_motif_alt_reference",
                       help="Estimate motif-centered alternative model.")
    _add_fast5_dirs_arg(p)
    p.add_argument("--reference", required=True)
    p.add_argument("--alternate-model-filename", required=True)
    p.add_argument("--alternate-model-name", required=True)
    p.add_argument("--valid-locations-filename",
                   help="6-field BED of single-base locations of valid "
                        "(modified) sites; only motif sites listed here "
                        "contribute to the alternate model.")
    p.add_argument("--motif-description", required=True,
                   help="motif:mod_pos (e.g. CCWGG:2)")
    p.add_argument("--upstream-bases", type=int, default=1)
    p.add_argument("--downstream-bases", type=int, default=1)
    p.add_argument("--minimum-kmer-observations", type=int, default=5)
    p.add_argument("--minimum-test-reads", type=int, default=10)
    p.add_argument("--coverage-threshold", type=int)
    p.add_argument("--multiprocess-region-size", type=int,
                   default=config.DEFAULT_REGION_SIZE)
    _add_common(p)
    p.set_defaults(func=_est_motif_alt)

    def _event_rsq(args):
        """The legacy event-table re-squiggle (host only: FAST5 files on
        numpy); an alignment file or an external aligner's executable
        replaces the in-process aligner."""
        from ..io.fasta import Fasta
        from ..pipeline.event_resquiggle import event_resquiggle_all_reads
        fasta = Fasta.read(args.reference)
        mapper_exe = mapper_type = None
        for exe, mtype in ((args.minimap2_executable, "minimap2"),
                           (args.bwa_mem_executable, "bwa_mem"),
                           (args.graphmap_executable, "graphmap")):
            if exe is not None:
                mapper_exe, mapper_type = exe, mtype
                break
        aligner = (None if args.alignment_file is not None or
                   mapper_exe is not None else _open_genomic_aligner(args))
        n_ok, n_fail, fails = event_resquiggle_all_reads(
            args.fast5_basedir, aligner, args.basecall_group,
            args.basecall_subgroups[0], args.corrected_group,
            overwrite=args.overwrite,
            num_threads=args.resquiggle_processes or args.processes,
            norm_type=args.normalization_type,
            pore_model_fn=args.pore_model_filename,
            sam_fn=args.alignment_file, fasta=fasta,
            genome_fn=args.reference, mapper_exe=mapper_exe,
            mapper_type=mapper_type, minimap2_index=args.minimap2_index,
            alignment_batch_size=args.alignment_batch_size,
            align_processes=args.align_processes,
            align_threads_per_process=args.align_threads_per_process,
            timeout=args.timeout, num_cpts_limit=args.cpts_limit)
        if not args.quiet:
            print("Event re-squiggle complete: %d succeeded, %d failed"
                  % (n_ok, n_fail))
            for mode, cnt in sorted(fails.items(), key=lambda kv: -kv[1]):
                print("  %5d : %s" % (cnt, mode))
        return 0
    p = sub.add_parser("event_resquiggle",
                       help="Re-annotate raw signal using the basecaller "
                            "event table (legacy algorithm).")
    p.add_argument("fast5_basedir")
    p.add_argument("reference")
    p.add_argument("--basecall-group", default="Basecall_1D_000")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--allow-exact-aligner", action="store_true",
                   help="Permit the built-in exact aligner when mappy and "
                        "the native aligner are unavailable (synthetic or "
                        "error-free reads only).")
    p.add_argument("--alignment-file",
                   help="SAM (or .m5) file from an external aligner "
                        "(graphmap, bwa-mem, minimap2); replaces "
                        "in-process mapping.")
    p.add_argument("--normalization-type", default="median",
                   choices=("median", "pA", "pA_raw", "none"),
                   help='"none": raw DAC values; "pA_raw": pA via channel '
                        'offset/range/digitisation; "pA": k-mer-model '
                        "fitted pA correction (requires "
                        "--pore-model-filename). Default: %(default)s")
    p.add_argument("--pore-model-filename",
                   help="TSV pore model (kmer, level_mean, level_stdv "
                        "columns) for pA normalization.")
    # external aligners (reference: tombo/_option_parsers.py:268-301;
    # the first given of minimap2, bwa-mem, graphmap is used)
    p.add_argument("--minimap2-executable",
                   help="Path to minimap2 executable; reads are mapped by "
                        "batched subprocess calls.")
    p.add_argument("--minimap2-index",
                   help="Pre-built minimap2 genome index (.mmi).")
    p.add_argument("--bwa-mem-executable",
                   help="Path to bwa-mem executable.")
    p.add_argument("--graphmap-executable",
                   help="Path to graphmap executable.")
    p.add_argument("--alignment-batch-size", type=int, default=1000,
                   help="Reads per aligner invocation. Default: "
                        "%(default)s")
    p.add_argument("--align-processes", type=int, default=1,
                   help="Concurrent aligner invocations. Default: "
                        "%(default)s")
    p.add_argument("--align-threads-per-process", type=int, default=1,
                   help="Threads per aligner invocation (-t). Default: "
                        "%(default)s")
    p.add_argument("--resquiggle-processes", type=int,
                   help="Worker threads for the re-segmentation stage "
                        "(defaults to --processes).")
    p.add_argument("--timeout", type=int,
                   help="Timeout in seconds for re-segmenting a single "
                        "read. Default: no timeout.")
    p.add_argument("--cpts-limit", type=int,
                   help="Maximum changepoints within a single indel "
                        "group. Default: no limit.")
    _add_common(p, device=False)
    p.set_defaults(func=_event_rsq)

    def _est_scale(args):
        """The mean of raw-signal MADs over up to ``--num-reads`` files,
        shuffled with seed 0 (the JAX command's estimate)."""
        from ..pipeline.runner import Fast5Reads
        from ..io import fast5 as f5io
        fns = list(f5io.iter_fast5_reads(args.fast5_basedir))
        np.random.default_rng(0).shuffle(fns)
        mads = []
        for fn in fns:
            try:
                sig = Fast5Reads.raw(fn)
            except (OSError, TomboError):
                continue
            mads.append(np.median(np.abs(sig - np.median(sig))))
            if len(mads) >= args.num_reads:
                break
        if not mads:
            raise TomboError(
                "No reads contain raw signal for global scale parameter "
                "estimation.")
        print("Global scaling estimate: %f" % np.mean(mads))
        return 0
    p = sub.add_parser("estimate_scale",
                       help="Estimate global scale from reads.")
    p.add_argument("fast5_basedir")
    p.add_argument("--num-reads", type=int, default=500)
    p.add_argument("--quiet", "-q", action="store_true")
    _add_device(p)
    p.set_defaults(func=_est_scale)


# ------------------------------------------------------------------- main

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tombo-tpu-torch",
        description="tombo-tpu-torch: nanopore raw-signal re-squiggle, "
                    "modified-base detection and model estimation on a "
                    "CUDA card (PyTorch).")
    parser.add_argument("-v", "--version", action="version",
                        version="tombo-tpu-torch " + VERSION)
    subparsers = parser.add_subparsers(dest="command", required=True)
    _add_resquiggle_parser(subparsers)
    _add_preprocess_parsers(subparsers)
    _add_filter_parsers(subparsers)
    _add_detect_parsers(subparsers)
    _add_text_output_parsers(subparsers)
    _add_build_model_parsers(subparsers)
    from ..plot import add_plot_parsers
    add_plot_parsers(subparsers)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if "--print-available-models" in argv:
        # before argument validation, as the reference exits early
        # (reference: tombo/tombo_stats.py:4985-4987)
        for key, fn in sorted(config.ALTERNATE_MODELS.items()):
            samp, alt = key.split("_", 1)
            print("%s (%s): %s" % (alt, samp, fn))
        return 0
    parser = build_parser()
    args = parser.parse_args(argv)
    if hasattr(args, "fast5_basedirs_opt"):
        args.fast5_basedirs = (list(args.fast5_basedirs) +
                               list(args.fast5_basedirs_opt or []))
        if not args.fast5_basedirs:
            parser.error(
                "Must provide FAST5 base directories (--fast5-basedirs)")
    from ..device import resolve_device
    try:
        if hasattr(args, "device") and \
                not getattr(args, "print_advanced_arguments", False):
            resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        return _error(str(e))
    try:
        return args.func(args)
    except TomboError as e:
        return _error(str(e))


def _error(msg: str) -> int:
    print("******** ERROR ********\n\t" + msg, file=sys.stderr)
    return 1

if __name__ == "__main__":
    sys.exit(main())

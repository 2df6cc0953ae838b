"""``tombo-tpu-torch plot`` subcommands (counterpart of
``tombo_tpu/plot/cli.py``; reference: tombo/__main__.py:104-147): the JAX
command's options and defaults, rendered with matplotlib to PDF.  The
commands whose data the port computes as tensor operations (``roc`` and
its three variants, ``max_difference``, ``kmer``,
``cluster_most_significant``) also take ``--device`` (default ``cuda``;
without a card they fail unless ``--device cpu`` is given).  The signal
plots read raw signal from FAST5 files on the host."""
from __future__ import annotations

from .. import config
from ..errors import TomboError


def _reads_index(dirs, args):
    from ..io.index import ReadsIndex
    return ReadsIndex(dirs, args.corrected_group)


def _common(p, with_dirs=True):
    if with_dirs:
        # accepted both ways: the reference's --fast5-basedirs option
        # (tombo/_option_parsers.py:88-93) and positionally; merged and
        # validated centrally in cli.main
        p.add_argument("fast5_basedirs", nargs="*", default=[])
        p.add_argument("--fast5-basedirs", dest="fast5_basedirs_opt",
                       nargs="+",
                       help="Directories containing FAST5 files.")
    p.add_argument("--corrected-group",
                   default=config.DEFAULT_CORRECTED_GROUP)
    p.add_argument("--pdf-filename", default="tombo_results.plot.pdf")
    p.add_argument("--num-regions", type=int, default=10)
    p.add_argument("--num-bases", type=int, default=21)
    p.add_argument("--num-reads", type=int, default=50)
    p.add_argument("--quiet", "-q", action="store_true")


def _device_opt(p):
    p.add_argument("--device", default="cuda",
                   help='Device of the plot data\'s tensor work: "cuda" '
                        '(the card, the default) or "cpu".')


def _overplot_opts(p):
    # reference: tombo/_option_parsers.py:343-346,649-652
    p.add_argument("--overplot-threshold", type=int, default=50,
                   help="Coverage level triggering the alternative plot "
                        "type. Default: %(default)s")
    p.add_argument("--overplot-type", default="Downsample",
                   choices=["Downsample", "Boxplot", "Quantile",
                            "Density"],
                   help="Plot type for regions with higher coverage. "
                        "Default: %(default)s")


def _model_opts(p):
    # reference: tombo/_option_parsers.py:499-501,717-721
    p.add_argument("--plot-standard-model", action="store_true",
                   help="Overlay the default standard model "
                        "distribution.")
    p.add_argument("--plot-alternate-model",
                   choices=sorted(k.split("_", 1)[1]
                                  for k in config.ALTERNATE_MODELS),
                   help="Overlay an alternative model distribution.")


def _load_plot_models(args, idx):
    """Resolve (std_model, alt_model) for signal-plot overlays; the sample
    type comes from the indexed reads' rna flag."""
    std_model = alt_model = None
    if not (getattr(args, "plot_standard_model", False) or
            getattr(args, "plot_alternate_model", None)):
        return std_model, alt_model
    from ..io.model_io import AltModel, KmerModel
    rna = any(r.rna for r in list(idx.iter_reads())[:1])
    samp_type = config.RNA_SAMP_TYPE if rna else config.DNA_SAMP_TYPE
    if args.plot_standard_model:
        std_model = KmerModel.load_default(samp_type)
    if args.plot_alternate_model:
        alt_model = AltModel.load_default(args.plot_alternate_model,
                                          samp_type)
        if alt_model is None:
            raise TomboError(
                "No default %s model for %s samples."
                % (args.plot_alternate_model, samp_type))
    return std_model, alt_model


def add_plot_parsers(subparsers):
    grp = subparsers.add_parser(
        "plot", help="Plot nanopore signal and testing results.")
    sub = grp.add_subparsers(dest="subcommand", required=True)

    # ------------------------------------------------ signal plots
    def _max_cov(args):
        from . import signal as psig
        idx = _reads_index(args.fast5_basedirs, args)
        regions = psig.select_max_coverage_regions(
            idx, args.num_regions, args.num_bases)
        for reg in regions:
            reg.add_reads(idx)
        from ..io.fasta import Fasta
        fasta = Fasta.read(args.genome_fasta) if args.genome_fasta else None
        std_m, alt_m = _load_plot_models(args, idx)
        psig.plot_intervals(regions, args.pdf_filename, fasta,
                            args.num_reads, None, args.overplot_threshold,
                            args.overplot_type, std_m, alt_m)
        return 0
    p = sub.add_parser("max_coverage",
                       help="Plot raw signal at maximal coverage.")
    _common(p)
    p.add_argument("--genome-fasta")
    _overplot_opts(p)
    _model_opts(p)
    p.set_defaults(func=_max_cov)

    def _genome_locs(args):
        from . import signal as psig
        from ..stats.region import RegionData
        idx = _reads_index(args.fast5_basedirs, args)
        regions = []
        for loc in args.genome_locations:
            parts = loc.split(":")
            chrm, pos = parts[0], int(parts[1].replace(",", "")) - 1
            strand = parts[2] if len(parts) > 2 else "+"
            start = max(0, pos - args.num_bases // 2)
            regions.append(RegionData(chrm, strand, start,
                                      start + args.num_bases).add_reads(idx))
        from ..io.fasta import Fasta
        fasta = Fasta.read(args.genome_fasta) if args.genome_fasta else None
        std_m, alt_m = _load_plot_models(args, idx)
        psig.plot_intervals(regions, args.pdf_filename, fasta,
                            args.num_reads, None, args.overplot_threshold,
                            args.overplot_type, std_m, alt_m)
        return 0
    p = sub.add_parser("genome_locations",
                       help="Plot raw signal at defined locations.")
    _common(p)
    p.add_argument("--genome-locations", nargs="+", required=True,
                   help="chrm:pos[:strand] (1-based)")
    p.add_argument("--genome-fasta")
    _overplot_opts(p)
    _model_opts(p)
    p.set_defaults(func=_genome_locs)

    def _motif_centered(args):
        from . import signal as psig
        from ..io.fasta import Fasta
        from ..seq import TomboMotif
        idx = _reads_index(args.fast5_basedirs, args)
        fasta = Fasta.read(args.genome_fasta)
        motif = TomboMotif(args.motif, 1)
        regions = psig.select_motif_regions(
            fasta, motif, idx, args.num_regions, args.num_bases,
            deepest_coverage=args.deepest_coverage)
        for reg in regions:
            reg.add_reads(idx)
        std_m, alt_m = _load_plot_models(args, idx)
        psig.plot_intervals(regions, args.pdf_filename, fasta,
                            args.num_reads, None, args.overplot_threshold,
                            args.overplot_type, std_m, alt_m)
        return 0
    p = sub.add_parser("motif_centered",
                       help="Plot raw signal at a specific motif.")
    _common(p)
    p.add_argument("--motif", required=True)
    p.add_argument("--genome-fasta", required=True)
    p.add_argument("--deepest-coverage", action="store_true",
                   help="Plot the deepest coverage motif sites (default: "
                        "random covered sites).")
    _overplot_opts(p)
    _model_opts(p)
    p.set_defaults(func=_motif_centered)

    def _max_diff(args):
        from . import signal as psig
        idx = _reads_index(args.fast5_basedirs, args)
        ctrl = _reads_index(args.control_fast5_basedirs, args)
        regions = psig.max_difference_regions(
            idx, ctrl, args.num_regions, args.num_bases, args.device)
        psig.plot_intervals(regions, args.pdf_filename, None,
                            args.num_reads, None, args.overplot_threshold,
                            args.overplot_type)
        return 0
    p = sub.add_parser("max_difference",
                       help="Plot where signal differs most between "
                            "samples.")
    _common(p)
    p.add_argument("--control-fast5-basedirs", nargs="+", required=True)
    _overplot_opts(p)
    _device_opt(p)
    p.set_defaults(func=_max_diff)

    def _most_signif(args):
        from . import signal as psig
        from ..io.fasta import Fasta
        from ..output.text import load_stats_file
        from ..stats.region import RegionData
        idx = _reads_index(args.fast5_basedirs, args)
        fasta = (Fasta.read(args.genome_fasta) if args.genome_fasta else None)
        regions = []
        titles = []
        for chrm, start, end, strand, _rid, txt in load_stats_file(
                args.statistics_filename).get_most_signif_regions(
                    args.num_bases, args.num_regions):
            regions.append(RegionData(chrm, strand, start,
                                      end).add_reads(idx))
            titles.append("%s:%d-%d (%s) %s" % (chrm, start + 1, end,
                                                strand, txt))
        std_m, alt_m = _load_plot_models(args, idx)
        psig.plot_intervals(regions, args.pdf_filename, fasta,
                            args.num_reads, titles,
                            args.overplot_threshold, args.overplot_type,
                            std_m, alt_m)
        return 0
    p = sub.add_parser("most_significant",
                       help="Plot raw signal at most modified locations.")
    _common(p)
    p.add_argument("--statistics-filename", required=True)
    p.add_argument("--genome-fasta")
    _overplot_opts(p)
    _model_opts(p)
    p.set_defaults(func=_most_signif)

    def _per_read(args):
        from . import signal as psig
        from ..stats.files import PerReadStats
        from ..stats.region import RegionData
        prs = PerReadStats(args.per_read_statistics_filename)
        regions = []
        for loc in args.genome_locations:
            parts = loc.split(":")
            chrm, pos = parts[0], int(parts[1].replace(",", "")) - 1
            strand = parts[2] if len(parts) > 2 else "+"
            start = max(0, pos - args.num_bases // 2)
            regions.append(RegionData(chrm, strand, start,
                                      start + args.num_bases))
        psig.plot_per_read_stats(prs, regions, args.pdf_filename,
                                 args.num_reads,
                                 box_center=args.box_center)
        return 0
    p = sub.add_parser("per_read",
                       help="Plot per-read modification statistics.")
    p.add_argument("--box-center", action="store_true",
                   help="Outline the central base column.")
    p.add_argument("--per-read-statistics-filename", required=True)
    p.add_argument("--genome-locations", nargs="+", required=True)
    p.add_argument("--pdf-filename", default="tombo_results.plot.pdf")
    p.add_argument("--num-bases", type=int, default=51)
    p.add_argument("--num-reads", type=int, default=100)
    p.add_argument("--corrected-group",
                   default=config.DEFAULT_CORRECTED_GROUP)
    p.add_argument("--quiet", "-q", action="store_true")
    p.set_defaults(func=_per_read)

    # -------------------------------------------------- accuracy plots
    def _roc_common(p, per_read=False):
        p.add_argument("--statistics-filenames", nargs="+",
                       required=not per_read)
        if per_read:
            p.add_argument("--per-read-statistics-filenames", nargs="+")
        p.add_argument("--motif-descriptions", nargs="+",
                       help='"motif:mod_pos:name[::...]" per stats file')
        p.add_argument("--modified-locations", nargs="+",
                       help='"mod_name:locs.bed" per stats file')
        p.add_argument("--unmodified-locations", nargs="+")
        p.add_argument("--genome-fasta")
        p.add_argument("--pdf-filename", default="tombo_results.roc.pdf")
        p.add_argument("--statistics-per-block", type=int, default=100000)
        p.add_argument("--total-statistics-limit", type=int,
                       default=5000000)
        p.add_argument("--quiet", "-q", action="store_true")
        _device_opt(p)

    def _gather_roc_stats(args, stats_objs):
        from . import accuracy as acc
        from ..io.fasta import Fasta
        from ..output.text import parse_motif_descs
        all_stats = {}
        if args.motif_descriptions:
            fasta = Fasta.read(args.genome_fasta)
            for stats, descs in zip(stats_objs, args.motif_descriptions):
                motif_descs = parse_motif_descs(descs)
                for mod_name, mod_stats in acc.compute_motif_stats(
                        stats, motif_descs, fasta,
                        args.statistics_per_block,
                        args.total_statistics_limit).items():
                    all_stats[mod_name] = mod_stats
        else:
            if not args.modified_locations:
                raise TomboError(
                    "Must provide either motifs or bed files describing "
                    "ground truth modification locations.")
            from .accuracy import parse_locs_file
            for stats, mod_desc, unmod_fn in zip(
                    stats_objs, args.modified_locations,
                    args.unmodified_locations):
                mod_name, mod_fn = mod_desc.split(":")
                gt = (parse_locs_file(mod_fn), parse_locs_file(unmod_fn),
                      mod_name)
                from .accuracy import compute_ground_truth_stats
                all_stats.update(compute_ground_truth_stats(stats, gt))
        return all_stats

    def _roc(args):
        from . import accuracy as acc
        from ..output.text import load_stats_file
        stats_objs = [load_stats_file(fn)
                      for fn in args.statistics_filenames]
        all_stats = _gather_roc_stats(args, stats_objs)
        curves = acc.prep_accuracy_rates(all_stats,
                                         verbose=not args.quiet,
                                         device=args.device)
        acc.plot_roc_curves(curves, args.pdf_filename)
        return 0
    p = sub.add_parser("roc", help="Plot ROC curve from known motifs.")
    _roc_common(p)
    p.set_defaults(func=_roc)

    def _gather_ctrl_roc_stats(args, stats_objs, ctrl_objs):
        """Native-vs-control accuracy at motif sites (reference:
        tombo/tombo_stats.py:2485-2533)."""
        from . import accuracy as acc
        from ..io.fasta import Fasta
        from ..output.text import parse_motif_descs
        if not args.motif_descriptions:
            raise TomboError(
                "Control-sample ROC requires --motif-descriptions.")
        fasta = Fasta.read(args.genome_fasta)
        all_stats = {}
        for stats, ctrl, descs in zip(stats_objs, ctrl_objs,
                                      args.motif_descriptions):
            for mod_name, mod_stats in acc.compute_ctrl_motif_stats(
                    stats, ctrl, parse_motif_descs(descs), fasta,
                    args.statistics_per_block,
                    args.total_statistics_limit).items():
                all_stats[mod_name] = mod_stats
        return all_stats

    def _sample_compare_roc(args):
        from . import accuracy as acc
        from ..output.text import load_stats_file
        if args.control_statistics_filenames:
            stats_objs = [load_stats_file(fn)
                          for fn in args.statistics_filenames]
            ctrl_objs = [load_stats_file(fn)
                         for fn in args.control_statistics_filenames]
            all_stats = _gather_ctrl_roc_stats(args, stats_objs,
                                               ctrl_objs)
            curves = acc.prep_accuracy_rates(all_stats,
                                             verbose=not args.quiet,
                                             device=args.device)
            acc.plot_roc_curves(curves, args.pdf_filename)
            return 0
        # no control stats: same machinery as the plain ROC
        return _roc(args)
    p = sub.add_parser("sample_compare_roc",
                       help="ROC comparing two samples at known motifs.")
    _roc_common(p)
    p.add_argument("--control-statistics-filenames", nargs="+",
                   help="Control-sample statistics files (one per "
                        "--statistics-filenames entry); sites from the "
                        "native sample count as modified, control sites "
                        "as unmodified.")
    p.set_defaults(func=_sample_compare_roc)

    def _per_read_roc(args):
        from . import accuracy as acc
        from ..stats.files import PerReadStats
        fns = (args.per_read_statistics_filenames or
               args.statistics_filenames)
        if not fns:
            raise TomboError(
                "Must provide --per-read-statistics-filenames.")
        stats_objs = []
        for fn in fns:
            prs = PerReadStats(fn)
            stats_objs.append(acc._PerReadStatsIterAdapter(
                prs, prs.are_pvals))
        all_stats = _gather_roc_stats(args, stats_objs)
        curves = acc.prep_accuracy_rates(all_stats,
                                         verbose=not args.quiet,
                                         device=args.device)
        acc.plot_roc_curves(curves, args.pdf_filename)
        return 0
    p = sub.add_parser("per_read_roc",
                       help="Per-read ROC from known motifs.")
    _roc_common(p, per_read=True)
    p.set_defaults(func=_per_read_roc)

    def _sample_compare_per_read_roc(args):
        from . import accuracy as acc
        from ..stats.files import PerReadStats
        if args.per_read_control_statistics_filenames:
            def adapt(fns):
                out = []
                for fn in fns:
                    prs = PerReadStats(fn)
                    out.append(acc._PerReadStatsIterAdapter(
                        prs, prs.are_pvals))
                return out
            stats_objs = adapt(args.per_read_statistics_filenames or
                               args.statistics_filenames)
            ctrl_objs = adapt(args.per_read_control_statistics_filenames)
            all_stats = _gather_ctrl_roc_stats(args, stats_objs,
                                               ctrl_objs)
            curves = acc.prep_accuracy_rates(all_stats,
                                             verbose=not args.quiet,
                                             device=args.device)
            acc.plot_roc_curves(curves, args.pdf_filename)
            return 0
        return _per_read_roc(args)
    p = sub.add_parser("sample_compare_per_read_roc",
                       help="Per-read ROC comparing samples.")
    _roc_common(p, per_read=True)
    p.add_argument("--per-read-control-statistics-filenames", nargs="+",
                   help="Control-sample per-read statistics files (one "
                        "per native per-read stats file).")
    p.set_defaults(func=_sample_compare_per_read_roc)

    # ------------------------------------------------------ other plots
    def _kmer(args):
        from . import signal as psig
        idx = _reads_index(args.fast5_basedirs, args)
        psig.plot_kmer_dist(idx, args.pdf_filename, args.kmer_width,
                            args.num_reads, args.read_mean,
                            num_kmer_threshold=args.num_kmer_threshold,
                            dont_plot=args.dont_plot,
                            data_fn=args.r_data_filename,
                            device=args.device)
        return 0
    p = sub.add_parser("kmer", help="Plot signal across k-mers.")
    _common(p)
    p.add_argument("--kmer-width", type=int, default=2)
    p.add_argument("--read-mean", action="store_true")
    p.add_argument("--num-kmer-threshold", type=int, default=1,
                   help="Observations of each k-mer required to include "
                        "a read. Default: %(default)s")
    p.add_argument("--dont-plot", action="store_true",
                   help="Only produce the data file, no PDF.")
    p.add_argument("--r-data-filename",
                   help="Save the plotted k-mer levels (a Python pickle "
                        "here, substituting the reference's R workspace).")
    _device_opt(p)
    p.set_defaults(func=_kmer)

    def _cluster(args):
        from . import signal as psig
        from ..io.fasta import Fasta
        idx = _reads_index(args.fast5_basedirs, args)
        ctrl = (_reads_index(args.control_fast5_basedirs, args)
                if args.control_fast5_basedirs else None)
        psig.cluster_most_significant(
            idx, ctrl, args.statistics_filename,
            Fasta.read(args.genome_fasta) if args.genome_fasta else None,
            args.pdf_filename, args.num_regions, args.num_bases,
            slide_span=args.slide_span, data_fn=args.r_data_filename,
            device=args.device)
        return 0
    p = sub.add_parser("cluster_most_significant",
                       help="Cluster traces at most significant sites.")
    _common(p)
    p.add_argument("--statistics-filename", required=True)
    p.add_argument("--control-fast5-basedirs", nargs="+")
    p.add_argument("--genome-fasta")
    p.add_argument("--slide-span", type=int, default=0,
                   help="Bases of offset to search when aligning traces "
                        "for clustering. Default: 0 (exact position)")
    p.add_argument("--r-data-filename",
                   help="Save the clustered matrices (a Python pickle "
                        "here, substituting the reference's R workspace).")
    _device_opt(p)
    p.set_defaults(func=_cluster)

    def _motif_with_stats(args):
        from . import signal as psig
        from ..io.fasta import Fasta
        from ..seq import TomboMotif
        idx = _reads_index(args.fast5_basedirs, args)
        fasta = Fasta.read(args.genome_fasta)
        motif = TomboMotif(args.motif, 1)
        std_m, alt_m = _load_plot_models(args, idx)
        if args.statistics_filename:
            psig.plot_motif_with_stats(
                idx, fasta, motif, args.statistics_filename,
                args.pdf_filename, args.num_regions, args.num_context,
                args.num_statistics, args.num_reads,
                args.overplot_threshold, args.overplot_type,
                model=std_m, alt_model=alt_m)
            return 0
        regions = psig.select_motif_regions(
            fasta, motif, idx, args.num_regions, args.num_bases)
        for reg in regions:
            reg.add_reads(idx)
        psig.plot_intervals(regions, args.pdf_filename, fasta,
                            args.num_reads, None, args.overplot_threshold,
                            args.overplot_type, std_m, alt_m)
        return 0
    p = sub.add_parser("motif_with_stats",
                       help="Plot signal and statistics around a motif.")
    _common(p)
    p.add_argument("--motif", required=True)
    p.add_argument("--genome-fasta", required=True)
    p.add_argument("--statistics-filename")
    p.add_argument("--num-context", type=int, default=5,
                   help="Context bases around the motif. Default: "
                        "%(default)s")
    p.add_argument("--num-statistics", type=int, default=200,
                   help="Motif-centered sites in the statistic "
                        "distributions. Default: %(default)s")
    _overplot_opts(p)
    _model_opts(p)
    p.set_defaults(func=_motif_with_stats)

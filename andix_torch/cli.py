"""Command line interface of ``andix-torch``, flag-for-flag compatible
with andi and with ``andix``'s CLI (a copy of ``andix/cli.py``).

Mirrors ``src/andi.c``: same option set, validation, warnings, exit codes,
defaults.  Extensions beyond the reference: ``--seed`` (reproducible
bootstrap — the reference's TODO at src/andi.c:278), ``--backend``
(``auto``/``cuda`` run on every visible card, ``cpu`` runs the plain
PyTorch versions; no fallback between them) and ``--block-size``.

Under ``torchrun --nproc-per-node=N -m andix_torch.cli ...`` the
processes join one group (``_distributed``) before any card is touched,
each takes one card, and rank 0 alone shows progress and prints; the
other ranks print nothing.
"""

from __future__ import annotations

import getopt
import math
import os
import sys

import numpy as np

from . import _distributed, fasta, ingest, output, pipeline, spans
from .device import DeviceError, resolve_devices
from .model import CountMatrix, model_average, model_bootstrap
from .runtime import Context, Model, Progress
from .sequence import Seq

LENGTH_LIMIT = (2**31 - 2) // 2  # (INT_MAX - 1) / 2, src/andi.c:296

USAGE = """Usage: andix [OPTIONS...] FILES...
\tFILES... can be any sequence of FASTA files.
\tUse '-' as file name to read from stdin.
Options:
  -b, --bootstrap=INT  Print additional bootstrap matrices
      --file-of-filenames=FILE  Read additional filenames from FILE; one per line
  -j, --join           Treat all sequences from one file as a single genome
  -l, --low-memory     Use less memory at the cost of speed
  -m, --model=MODEL    Pick an evolutionary model of 'Raw', 'JC', 'Kimura', 'LogDet', 'ANI'; default: JC
  -p FLOAT             Significance of an anchor; default: 0.025
      --progress=WHEN  Print a progress bar 'always', 'never', or 'auto'; default: auto
  -t, --threads=INT    Set the number of threads; by default, all processors are used
      --truncate-names Truncate names to ten characters
      --seed=INT       Seed the bootstrap RNG for reproducible output
      --backend=NAME   Compute backend: 'auto', 'cuda', or 'cpu'; default: auto
      --checkpoint=DIR Resume-able row-tile checkpoints in DIR
  -v, --verbose        Prints additional information
  -h, --help           Display this help and exit
      --version        Output version information and acknowledgments
"""

VERSION_TEXT = """andix {version}
A PyTorch/CUDA reimplementation of the andi anchor-distance method.
License GPLv3+: GNU GPL version 3 or later <http://gnu.org/licenses/gpl.html>
This is free software: you are free to change and redistribute it.
There is NO WARRANTY, to the extent permitted by law.

Acknowledgments:
1) Method: Haubold, B. Klötzl, F. and Pfaffelhuber, P. (2015). Fast and \
accurate estimation of evolutionary distances between closely related \
genomes, Bioinformatics.
2) Bootstrapping: Klötzl, F. and Haubold, B. (2016). Support Values for \
Genome Phylogenies, Life 6.1.
"""


def usage(status: int) -> "int":
    print(USAGE, end="", file=sys.stdout if status == 0 else sys.stderr)
    return status


def version() -> int:
    from . import __version__

    print(VERSION_TEXT.format(version=__version__), end="")
    return 0


def parse_args(argv: list[str], ctx: Context) -> tuple[list[str], int | None]:
    """Parse flags into ctx.  Returns (file_names, early_exit_code)."""
    # getopt has no optional_argument: a bare --progress means "always"
    # (reference src/andi.c:111-113)
    argv = [
        "--progress=always" if a == "--progress" else a for a in argv
    ]
    try:
        opts, args = getopt.gnu_getopt(
            argv,
            "jvht:p:m:b:l",
            [
                "version",
                "truncate-names",
                "file-of-filenames=",
                "progress=",
                "help",
                "verbose",
                "join",
                "low-memory",
                "threads=",
                "bootstrap=",
                "model=",
                "seed=",
                "backend=",
                "block-size=",
                "checkpoint=",
            ],
        )
    except getopt.GetoptError as e:
        print(f"{ctx.prog}: {e}", file=sys.stderr)
        return [], usage(1)

    file_names: list[str] = []
    for opt, arg in opts:
        if opt == "--version":
            return [], version()
        elif opt == "--truncate-names":
            ctx.truncate_names = True
        elif opt == "--file-of-filenames":
            file_names.extend(fasta.read_into_string_vector(arg, ctx))
        elif opt == "--progress":
            val = arg if arg else "always"
            if val.lower() in ("always", "auto", "never"):
                ctx.progress = Progress(val.lower())
            else:
                ctx.warn(
                    f"invalid argument to --progress '{arg}'. Expected one "
                    f"of 'auto', 'always', or 'never'."
                )
        elif opt in ("-h", "--help"):
            return [], usage(0)
        elif opt in ("-v", "--verbose"):
            ctx.verbose = min(ctx.verbose + 1, 2)
        elif opt == "-p":
            try:
                prop = float(arg)
            except ValueError:
                ctx.soft_err(
                    f"Expected a floating point number for -p argument, but "
                    f"'{arg}' was given. Skipping argument."
                )
                continue
            if not math.isfinite(prop) or prop <= 0.0 or prop >= 1.0:
                ctx.soft_err(
                    f"A probability should be a value between 0 and 1, "
                    f"exclusive; Ignoring -p {prop:f} argument."
                )
                continue
            ctx.anchor_p_value = prop
        elif opt in ("-l", "--low-memory"):
            ctx.low_memory = True
        elif opt in ("-j", "--join"):
            ctx.join = True
        elif opt in ("-t", "--threads"):
            try:
                threads = int(arg)
                if threads < 0:
                    raise ValueError
            except ValueError:
                ctx.warn(
                    f"Expected a number for -t argument, but '{arg}' was "
                    f"given. Ignoring -t argument."
                )
                continue
            ctx.threads = threads
        elif opt in ("-b", "--bootstrap"):
            try:
                bootstrap = int(arg)
                if bootstrap <= 0:
                    raise ValueError
            except ValueError:
                ctx.soft_err(
                    f"Expected a positive number for -b argument, but "
                    f"'{arg}' was given. Ignoring -b argument."
                )
                continue
            ctx.bootstrap = bootstrap - 1
        elif opt in ("-m", "--model"):
            matched = None
            for kind in Model:
                if arg.lower() == kind.value.lower():
                    matched = kind
            if matched is None:
                ctx.soft_err(
                    "Ignoring argument for --model. Expected Raw, JC, "
                    "Kimura, LogDet or ANI"
                )
            else:
                ctx.model = matched
        elif opt == "--seed":
            ctx.seed = int(arg)
        elif opt == "--backend":
            ctx.backend = arg
        elif opt == "--block-size":
            ctx.block_syms = int(arg)
        elif opt == "--checkpoint":
            ctx.checkpoint_dir = arg

    file_names.extend(args)
    return file_names, None


def main(argv: list[str] | None = None) -> int:
    with spans.request():
        return _main(list(sys.argv[1:] if argv is None else argv))


def _main(argv: list[str]) -> int:
    ctx = Context()

    file_names, early = parse_args(argv, ctx)
    if early is not None:
        return early

    # at least one file name must be given in join mode (src/andi.c:233-235)
    if ctx.join and not file_names:
        print(
            f"{ctx.prog}: In join mode at least one filename needs to be "
            f"supplied.",
            file=sys.stderr,
        )
        return 1

    minfiles = 2 if ctx.join else 1
    if len(file_names) < minfiles:
        if not sys.stdin.isatty():
            file_names.append("-")
        else:
            return usage(1)

    card = ingest.card(ctx)
    with spans.span("fasta.read"):
        seqs = ingest.read(file_names, ctx, card)

    n = len(seqs)
    if n < 2:
        print(
            f"{ctx.prog}: I am truly sorry, but with less than two sequences "
            f"({n} given) there is nothing to compare.",
            file=sys.stderr,
        )
        return 1

    if ctx.non_acgt:
        ctx.warn(
            "The input sequences contained characters other than acgtACGT. "
            "These were automatically stripped to ensure correct results."
        )

    short = False
    for s in seqs:
        if ctx.truncate_names and len(s.name) > 10:
            ctx.warn(
                f"The sequence name '{s.name}' is longer than ten "
                f"characters. It will be truncated in the output to "
                f"'{s.name[:10]}'."
            )
        if s.len > LENGTH_LIMIT:
            print(
                f"{ctx.prog}: The sequence {s.name} is too long. The "
                f"technical limit is {LENGTH_LIMIT}.",
                file=sys.stderr,
            )
            return 1
        if s.len == 0:
            print(
                f"{ctx.prog}: The sequence {s.name} is empty.",
                file=sys.stderr,
            )
            return 1
        if s.len < 1000:
            short = True

    if short:
        ctx.soft_err(
            "One of the given input sequences is shorter than a thousand "
            "nucleotides. This may result in inaccurate distances. Try an "
            "alignment instead."
        )

    joined = _distributed.maybe_init_distributed()
    try:
        return _compute_and_print(seqs, ctx)
    finally:
        if joined:
            _distributed.shutdown()


def _compute_and_print(seqs: list[Seq], ctx: Context) -> int:
    """The grid on the devices ``--backend`` names (no fallback: a missing
    card is an error, see ``device.resolve_devices``); rank 0 prints."""
    n = len(seqs)
    try:
        devices = resolve_devices(ctx.backend)
    except DeviceError as e:
        print(f"{ctx.prog}: {e}", file=sys.stderr)
        return 1
    rank0 = _distributed.rank() == 0
    show_progress = rank0 and (
        ctx.progress == Progress.ALWAYS
        or (ctx.progress == Progress.AUTO and sys.stderr.isatty())
    )
    meter = output.ProgressMeter(n, show_progress)

    M = pipeline.calculate_matrix(
        seqs, ctx, devices, block_syms=ctx.block_syms,
        progress=meter if rank0 else None,
    )
    meter.done()
    if not rank0:
        return ctx.exit_code

    output.print_distances(M, seqs, n, True, ctx)
    if ctx.verbose >= 1:
        output.print_coverages(M, n)

    if ctx.bootstrap:
        calculate_bootstrap(M, seqs, n, ctx)

    return ctx.exit_code


def _bootstrap_matrix(n: int) -> "list[list[CountMatrix]]":
    B: list[list[CountMatrix]] = [[None] * n for _ in range(n)]  # type: ignore
    for i in range(n):
        diag = CountMatrix.zero(seq_len=1)
        diag.counts[0] = 1
        B[i][i] = diag
    return B


def calculate_bootstrap(
    M: list[list[CountMatrix]],
    seqs: list[Seq],
    n: int,
    ctx: Context,
) -> None:
    """Reference ``calculate_bootstrap``, src/process.c:289-321.

    The replicate stream is a pure function of (inputs, --seed): the
    seedable host float64 multinomial, the same stream ``andix`` prints,
    so ``-b`` output is byte-identical across the two packages.  As in
    ``andix``, ANDIX_DEVICE_BOOTSTRAP changes nothing but prints a note,
    and ANDIX_BOOTSTRAP_SHIM_SEED (test-only) swaps in the splitmix64 +
    conditional-binomial stream of the compiled parity oracle
    (``oracle.ShimRng``), so the `-b` stdout can be compared byte for
    byte with the reference binary."""
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    averaged = [model_average(M[i][j], M[j][i]) for i, j in pairs]

    if os.environ.get("ANDIX_DEVICE_BOOTSTRAP") == "1":
        print(
            "andix: ANDIX_DEVICE_BOOTSTRAP no longer changes the replicate "
            "stream (it is backend-invariant); using the host resampler.",
            file=sys.stderr,
        )

    shim_seed = os.environ.get("ANDIX_BOOTSTRAP_SHIM_SEED")
    if shim_seed is not None:
        from .oracle import ShimRng, shim_model_bootstrap

        shim = ShimRng(int(shim_seed))
        for _ in range(ctx.bootstrap):
            B = _bootstrap_matrix(n)
            for k, (i, j) in enumerate(pairs):
                datum = shim_model_bootstrap(averaged[k], shim)
                B[i][j] = datum
                B[j][i] = datum
            output.print_distances(B, seqs, n, False, ctx)
        return

    rng = np.random.default_rng(ctx.seed)
    for _ in range(ctx.bootstrap):
        B = _bootstrap_matrix(n)
        for k, (i, j) in enumerate(pairs):
            datum = model_bootstrap(averaged[k], rng)
            B[i][j] = datum
            B[j][i] = datum
        output.print_distances(B, seqs, n, False, ctx)


if __name__ == "__main__":
    sys.exit(main())

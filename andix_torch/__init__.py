"""andix_torch — the andix anchor-distance engine on PyTorch and CUDA.

A second package beside ``andix`` (the JAX reference).  It reads the same
FASTA inputs, takes the same CLI flags and prints the same PHYLIP bytes;
its device work runs as torch tensors on an NVIDIA GPU, with hand-written
CUDA kernels (``csrc/``) where ``andix`` had a Pallas kernel or a
launch-bound device loop.  Module names mirror ``andix``'s so each piece
has an obvious counterpart.

The package imports ``torch`` and numpy only — never ``jax`` and never
``andix``.  The device-free host modules (fasta, sequence, model, output,
runtime, esa.joint, esa.sa_numpy, chain.events, chain.replay_py, and
the numpy half of esa.subject_index) are verbatim copies of ``andix``'s,
held equal by the tests.  The segmented walk's host loop is compiled
(``chain.segdrive``, g++ at first use); the tests hold it to ``andix``'s
own ``chain.segmented``.

On a card the CLI reads its FASTA files there (``ingest``: one upload of
the files' bytes, one kernel launch that parses, normalizes and
reverse-complements them, under ``-j`` joining each file's records);
files it cannot prove exact, stdin and the CPU backend take ``fasta``'s
parser.  Two schedules, picked by
``ANDIX_INDEX`` as in ``andix``:

* joint (slice 1): CLI -> joint block -> SA/LCP -> matching statistics
  (flag-scan kernel) -> subject tables -> segmented chain walk (walk
  kernel) -> host counting -> estimators -> PHYLIP;
* subject index (slice 2): CLI -> per-subject index (SA, LCP, packed
  words, k-mer cache) -> segmented search walk (search-walk kernel) ->
  host counting -> estimators -> PHYLIP.

Both run on every visible card, a worker thread each, and across
processes under torchrun (slice 5: ``parallel``, ``_distributed``).
"""

__version__ = "0.1.0"

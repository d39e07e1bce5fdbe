"""andix-torch CLI (``--backend cpu``) against the andix CLI: stdout bytes
and exit codes must be identical for every model, bootstrap with a seed,
join mode, low-memory mode, verbose output and a bogus model."""

import numpy as np
import pytest
import torch

from andix import cli as jcli
from andix_torch import cli

torch.set_num_threads(2)


def _write_fasta(path, records, width=70):
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for k in range(0, len(seq), width):
                fh.write(seq[k: k + width] + "\n")


def _s(arr):
    return arr.tobytes().decode()


@pytest.fixture
def family(tmp_path, rng, dna, mutator):
    """Identical, close, mid and unrelated genomes (the last gives nan
    distances and a soft error)."""
    base = dna(rng, 2000)
    paths = []
    for k, s in enumerate([base, base.copy(), mutator(rng, base, 0.03),
                           mutator(rng, base, 0.08), dna(rng, 2000)]):
        p = tmp_path / f"g{k}.fasta"
        _write_fasta(p, [(f"g{k}", _s(s))])
        paths.append(str(p))
    return paths


def _both(capsys, args):
    code_j = jcli.main(list(args))
    out_j = capsys.readouterr().out
    code_t = cli.main(["--backend", "cpu"] + list(args))
    out_t = capsys.readouterr().out
    assert out_t == out_j
    assert code_t == code_j
    return code_t, out_t


@pytest.mark.parametrize("flags", [
    ["-m", "Raw"], ["-m", "JC"], ["-m", "Kimura"], ["-m", "LogDet"],
    ["-m", "ANI"], ["-b", "2", "--seed", "42"], ["-l"], ["-v"], ["-vv"],
    ["-m", "Bogus"],
])
def test_stdout_and_exit_code_equal(capsys, family, flags):
    code, out = _both(capsys, ["--progress=never"] + flags + family)
    assert out.startswith("5\n")
    if flags == ["-m", "Bogus"]:
        assert code == 1


def test_join_mode(capsys, tmp_path, rng, dna, mutator):
    base = [dna(rng, 1500), dna(rng, 900)]
    paths = []
    for k, rate in enumerate([0.0, 0.02, 0.06]):
        contigs = [b if rate == 0 else mutator(rng, b, rate) for b in base]
        p = tmp_path / f"strain{k}.fa"
        _write_fasta(p, [(f"c{i}", _s(c)) for i, c in enumerate(contigs)])
        paths.append(str(p))
    code, out = _both(capsys, ["--progress=never", "-j"] + paths)
    assert code == 0 and out.startswith("3\n")


def test_backend_errors(capsys, family, monkeypatch):
    """No fallback: jax/numpy are refused, and auto/cuda without a card
    are an error (exit 1) instead of a silent CPU run."""
    assert cli.main(["--backend", "jax", "--progress=never"] + family) == 1
    assert "unknown backend" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "cuda"):
        assert cli.main(["--backend", name, "--progress=never"]
                        + family) == 1
        captured = capsys.readouterr()
        assert captured.out == ""
        assert "needs a CUDA device" in captured.err


def test_auto_index_on_a_split_plan(capsys, family, monkeypatch):
    """``ANDIX_INDEX=auto``: a ``--block-size`` that splits the joint plan
    sends both packages to the subject index, with equal stdout bytes and
    exit codes; one joint block stays on the joint schedule."""
    from andix_torch import subject_pipeline

    monkeypatch.setenv("ANDIX_INDEX", "auto")
    monkeypatch.setenv("ANDIX_SX_MESH", "0")
    runs = []
    orig = subject_pipeline.process_subject_index

    def recording(todo, *a, **kw):
        runs.append(list(todo))
        return orig(todo, *a, **kw)

    monkeypatch.setattr(subject_pipeline, "process_subject_index", recording)
    code, out = _both(capsys, ["--progress=never", "--block-size", "5000"]
                      + family)
    assert runs == [[0, 1, 2, 3, 4]]
    assert out.startswith("5\n") and code == 1  # the unrelated genome: nan
    _both(capsys, ["--progress=never"] + family)
    assert len(runs) == 1


@pytest.mark.parametrize("retreat", [False, True])
@pytest.mark.parametrize("index", ["joint", "subject"])
def test_duplicated_genome_on_both_schedules(capsys, tmp_path, rng, dna,
                                             mutator, monkeypatch, index,
                                             retreat):
    """A genome twice in the family and one made of a block twice over,
    on each schedule: with the level buffer that holds them, and with a
    level budget of 3 rows, where every LCP comes from the host Φ
    algorithm; stdout bytes and exit code equal andix's."""
    from andix_torch.esa import backend

    base = dna(rng, 1500)
    genomes = [base, base.copy(), np.concatenate([base[:700], base[:700]]),
               mutator(rng, base, 0.04)]
    paths = []
    for k, s in enumerate(genomes):
        p = tmp_path / f"d{k}.fasta"
        _write_fasta(p, [(f"d{k}", _s(s))])
        paths.append(str(p))
    monkeypatch.setenv("ANDIX_INDEX", index)
    monkeypatch.setenv("ANDIX_SX_MESH", "0")
    calls = []
    if retreat:
        lcp_from_sa = backend.native.lcp_from_sa

        def spy(sym, sa, threads=0):
            calls.append(len(sa))
            return lcp_from_sa(sym, sa, threads)

        monkeypatch.setattr(backend, "level_budget", lambda n, budget: 3)
        monkeypatch.setattr(backend.native, "lcp_from_sa", spy)
    code, out = _both(capsys, ["--progress=never"] + paths)
    assert out.startswith("4\n")
    assert bool(calls) == retreat


@pytest.mark.parametrize("device_note", [False, True])
def test_bootstrap_shim_stream(capsys, family, monkeypatch, device_note):
    """``-b 3`` under ANDIX_BOOTSTRAP_SHIM_SEED=7 draws the parity oracle's
    splitmix64 stream in both packages: stdout bytes equal, and so is
    stderr, which carries ANDIX_DEVICE_BOOTSTRAP's note when it is set."""
    monkeypatch.setenv("ANDIX_BOOTSTRAP_SHIM_SEED", "7")
    if device_note:
        monkeypatch.setenv("ANDIX_DEVICE_BOOTSTRAP", "1")
    args = ["--progress=never", "-b", "3"] + family
    code_j = jcli.main(list(args))
    out_j = capsys.readouterr()
    code_t = cli.main(["--backend", "cpu"] + args)
    out_t = capsys.readouterr()
    assert out_t.out == out_j.out and out_t.err == out_j.err
    assert code_t == code_j
    assert out_t.out.split("\n").count("5") == 3  # the matrix, 2 replicates
    assert ("ANDIX_DEVICE_BOOTSTRAP" in out_t.err) == device_note
    monkeypatch.delenv("ANDIX_BOOTSTRAP_SHIM_SEED")
    cli.main(["--backend", "cpu"] + args)
    assert capsys.readouterr().out != out_t.out  # the shim stream is other


def test_oracle_is_andix_s(rng, dna, mutator):
    """The port's oracle: ShimRng's first 64 draws (raw, uniform and
    binomial) and the brute-force matching statistics equal andix's."""
    from andix import oracle as joracle
    from andix_torch import oracle

    for seed in (0, 7, 2**63 + 5):
        a, b = oracle.ShimRng(seed), joracle.ShimRng(seed)
        assert [a.next64() for _ in range(64)] == [b.next64()
                                                   for _ in range(64)]
        assert [a.uniform() for _ in range(64)] == [b.uniform()
                                                    for _ in range(64)]
        assert ([a.binomial(0.3, 100) for _ in range(8)]
                == [b.binomial(0.3, 100) for _ in range(8)])
    rs = dna(rng, 120)
    query = mutator(rng, rs[10:90], 0.1)
    for x, y in zip(oracle.match_stats_brute(rs, query),
                    joracle.match_stats_brute(rs, query)):
        assert (x == y).all()

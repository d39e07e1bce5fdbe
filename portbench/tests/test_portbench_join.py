"""Draft assemblies in join mode: the harness writes each genome as
contigs and calls ``-j``; the reference joins the files as andi does and
agrees with the port's CPU CLI and with ``andix``'s, both under ``-j``.
The configurations without the two keys read as they always have, and a
configuration the harness cannot check is refused."""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from portbench_tiny import (DRAFT, ROOT, TINY, cut_config, make_tiny_root,
                            run_cell)

from portbench import family, run
from portbench.reference import andi

# sha256 over each file's name and bytes, as the harness wrote the cell's
# family before it knew join mode: TINY's size, seed 2**31 + 7
TODAY = {
    "bact8x5m.divergent":
        "78ecca29aada77faab358d2556c36c0f4b53d108e256f570744c13095cd1859f",
    "bact10x5m.divergent":
        "78ecca29aada77faab358d2556c36c0f4b53d108e256f570744c13095cd1859f",
    "bact8x5m.outbreak":
        "928dcc7da4d0ce68e9e3eba7b1ef9ef5ee42ad0481c14404aea442a0d721c55a",
    "eco29.divergent":
        "78ecca29aada77faab358d2556c36c0f4b53d108e256f570744c13095cd1859f",
}


def cell_inputs(root, name):
    bench = run.load_json(os.path.join(root, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = run.load_json(os.path.join(root, entry["file"]))
    traffic = run.load_json(os.path.join(root, "portbench", "traffic",
                                         cell["traffic"] + ".json"))
    return config, traffic


@pytest.mark.parametrize("name", sorted(TODAY))
def test_a_configuration_without_join_reads_as_before(tmp_path, monkeypatch,
                                                      name):
    """At TINY size each existing cell writes the same FASTA bytes, hands
    the reference the family's own names and genomes, and calls the CLI
    with the same argv as before join mode."""
    from andix_torch import cli

    config, traffic = cell_inputs(ROOT, name)
    assert run.refusal(config) is None
    config = cut_config(config)
    seed = 2**31 + 7
    seqs = family.make_family(config["genomes"], config["length"],
                              traffic["rates"], seed)
    paths = run.write_files(config, seqs, seed, str(tmp_path))
    digest = hashlib.sha256()
    for p in paths:
        digest.update(os.path.basename(p).encode())
        digest.update(open(p, "rb").read())
    assert digest.hexdigest() == TODAY[name]
    names, genomes = run.reference_input(config, seqs, paths)
    assert names == [n for n, _ in seqs]
    assert all(g is d for g, (_, d) in zip(genomes, seqs))
    seen = []
    real = cli.main
    monkeypatch.setattr(cli, "main",
                        lambda argv: seen.append(argv) or real(argv))
    mat = run.Program(ROOT, "cpu").matrix(paths, run.cli_options(config))
    assert seen == [["--backend", "cpu", "--progress=never", "-m", "JC",
                     *paths]]
    assert mat.code == 0 and mat.out.startswith("4\n")


# (genomes, length, rates, contigs a genome; None: one record): a
# genome's layout comes from seed + its index, but in
# ``joiner_meets_joiner`` g1 = g0 takes g0's breakpoints and strands
JOIN_FAMILIES = {
    "single_records": (3, 12_000, [0.01, 0.05], [None, None, None]),
    "unequal_contigs": (4, 20_000, [0.005, 0.03, 0.1], [1, 5, 17, None]),
    "all_reversed": (3, 15_000, [0.02, 0.06], [6, 9, 6]),
    "joiner_meets_joiner": (4, 16_000, [0.0, 0.001, 0.01], [10, 10, 10, 12]),
}


def write_join_family(directory, key, seed=2**31 + 41):
    n, length, rates, contigs = JOIN_FAMILIES[key]
    seqs = family.make_family(n, length, rates, seed)
    share = 1.0 if key == "all_reversed" else 0.5
    paths = []
    for k, (seq, c) in enumerate(zip(seqs, contigs)):
        if c is None:
            paths += family.write_fasta(directory, [seq])
            continue
        layout_seed = seed if key == "joiner_meets_joiner" and k == 1 \
            else seed + k
        paths += family.write_assembly(
            directory, [seq], dict(DRAFT, contigs=c, min_contig=300,
                                   reverse_share=share), layout_seed)
    return seqs, paths


ANDIX_CLI = """
import contextlib, io, json, sys
from andix import cli, model, pipeline
grids, estimates = [], []
calc, estimate = pipeline.calculate_matrix, model.estimate
def recording(*a, **k):
    grids.append(calc(*a, **k))
    return grids[-1]
def estimating(*a, **k):
    estimates.append(estimate(*a, **k))
    return estimates[-1]
pipeline.calculate_matrix, model.estimate = recording, estimating
out = {}
for key, paths in json.loads(sys.argv[1]).items():
    grids.clear(); estimates.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(["--progress=never", "-m", "JC", "-j"] + paths)
    g = grids[0]
    out[key] = {"code": code, "out": buf.getvalue(),
                "estimates": list(estimates),
                "counts": [[m.counts.tolist() for m in row] for row in g],
                "seq_len": [[int(m.seq_len) for m in row] for row in g]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def join_families(tmp_path_factory):
    """Each family's files, and what ``andix``'s CLI under ``-j`` made of
    them (JAX on the CPU, in a process of its own so that no JAX module
    reaches the harness's process)."""
    written = {}
    for key in JOIN_FAMILIES:
        directory = str(tmp_path_factory.mktemp(key))
        written[key] = write_join_family(directory, key)
    out = subprocess.run(
        [sys.executable, "-c", ANDIX_CLI,
         json.dumps({k: p for k, (_, p) in written.items()})],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    andix = json.loads(out.stdout.splitlines()[-1])
    return {k: (seqs, paths, andix[k]) for k, (seqs, paths) in written.items()}


def estimates_matrix(estimates, n):
    dist = np.full((n, n), np.nan)
    if len(estimates) == n * (n - 1):
        np.fill_diagonal(dist, 0.0)
        dist[~np.eye(n, dtype=bool)] = estimates
    return dist


@pytest.mark.parametrize("key", sorted(JOIN_FAMILIES))
def test_join_reference_is_the_ports_and_andix(join_families, key):
    """The reference's join mode gives both CLIs' counts, sequence
    lengths, PHYLIP text and exit code, and their unrounded distances
    within ``distance_gap``'s limit."""
    seqs, paths, andix = join_families[key]
    config = {"model": "JC", "join": True}
    names, genomes = run.reference_input(config, seqs, paths)
    assert names == [n for n, _ in seqs]
    ref = andi.Reference(genomes, 0.025, "cpu", 256)
    counts, seq_len = ref.counts()
    dist = andi.distances(counts)
    text, code = andi.phylip(names, counts, seq_len)
    n = len(seqs)
    joiners = [int((g == ord("!")).sum()) for g in genomes]
    want = [0 if c is None else c - 1 for c in JOIN_FAMILIES[key][3]]
    assert joiners == want
    assert np.array_equal(seq_len[0, 1:], [len(g) for g in genomes[1:]])

    port = run.Program(ROOT, "cpu").matrix(paths, run.cli_options(config))
    for label, got in (
            ("port", (port.counts, port.seq_len, port.dist, port.out,
                      port.code)),
            ("andix", (np.array(andix["counts"]), np.array(andix["seq_len"]),
                       estimates_matrix(andix["estimates"], n),
                       andix["out"], andix["code"]))):
        got_counts, got_len, got_dist, got_out, got_code = got
        assert np.array_equal(got_counts, counts), label
        assert np.array_equal(got_len, seq_len), label
        assert run.distance_gap(got_dist, dist) <= run.LIMITS[
            "distance_gap"], label
        assert got_out == text and got_code == code, label


def join_root(path, assembly=DRAFT, **changes):
    """A tiny root with one more configuration, ``draft``, a copy of
    ``bact8x5m`` in join mode with ``assembly`` cut to TINY, and its cell
    ``draft.divergent``."""
    root = make_tiny_root(path)
    pb = os.path.join(root, "portbench")
    cfg = json.load(open(os.path.join(pb, "configs", "bact8x5m.json")))
    cfg.update(name="draft", join=True, assembly=assembly)
    cfg = cut_config(cfg)
    for k, v in changes.items():
        if v is None:
            cfg.pop(k)
        else:
            cfg[k] = v
    json.dump(cfg, open(os.path.join(pb, "configs", "draft.json"), "w"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "draft", "source": "test",
                             "file": "portbench/configs/draft.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "draft.divergent", "config": "draft",
                               "traffic": "divergent", "chips": 1,
                               "why": "test"})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root


def test_cut_config_keeps_the_contigs_tiny_holds():
    cfg = cut_config({"genomes": 8, "length": 5_000_000, "assembly": DRAFT})
    assert cfg["length"] == TINY["length"]
    assert cfg["assembly"] == dict(DRAFT, contigs=40)
    assert DRAFT["contigs"] == 150
    assert cut_config({"assembly": dict(DRAFT, contigs=3)})[
        "assembly"]["contigs"] == 3


def test_a_whole_join_run_on_the_cpu(tmp_path, monkeypatch):
    """A tiny draft cell, 40 contigs a genome under ``-j``: correct, every
    check 0, and each call carries ``-j``."""
    from andix_torch import cli

    seen = []
    real = cli.main
    monkeypatch.setattr(cli, "main",
                        lambda argv: seen.append(argv) or real(argv))
    root = join_root(str(tmp_path))
    result, _ = run_cell(root, "draft.divergent")
    assert result["correct"] is True and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert seen and all(a[:6] == ["--backend", "cpu", "--progress=never",
                                  "-m", "JC", "-j"] and len(a) == 10
                        for a in seen)


def _no_joiner(monkeypatch):
    from andix_torch import sequence

    monkeypatch.setattr(sequence, "join", lambda seqs: np.concatenate(seqs))


def _no_join_flag(monkeypatch):
    from andix_torch import cli

    real = cli.main
    monkeypatch.setattr(cli, "main",
                        lambda argv: real([a for a in argv if a != "-j"]))


@pytest.mark.parametrize("fault,contigs", [(_no_joiner, 40),
                                           (_no_join_flag, 3)])
def test_a_join_fault_is_not_correct(tmp_path, monkeypatch, fault, contigs):
    """A port that joins contigs without '!', and one that drops ``-j``
    (each contig a taxon), are not correct."""
    fault(monkeypatch)
    root = join_root(str(tmp_path), dict(DRAFT, contigs=contigs))
    result, _ = run_cell(root, "draft.divergent")
    checks = result["checks"]
    assert result["correct"] is False
    assert max(checks["count_cells_off"]["value"],
               checks["matrix_lines_off"]["value"]) > 0


@pytest.mark.parametrize("changes,why", [
    ({"model": "LogDet"}, "the reference estimates JC alone"),
    ({"join": None}, "each contig would be a taxon of its own"),
])
def test_a_configuration_it_cannot_check_is_refused(tmp_path, monkeypatch,
                                                    changes, why):
    """A model other than JC, or an assembly without join: the run exits
    non-zero before it makes the family, says why, and prints no
    result."""
    root = join_root(str(tmp_path), **changes)

    def never(*args):
        raise AssertionError("the family was made")

    monkeypatch.setattr(family, "make_family", never)
    sys.path.insert(0, root)
    try:
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = run.run("draft.divergent", 5, 0.1, False, root=root,
                         backend="cpu", out=out)
    finally:
        sys.path.remove(root)
    assert rc != 0 and out.getvalue() == ""
    assert why in err.getvalue()


def test_control_is_not_correct_in_join_mode(tmp_path):
    """The control's readings on a tiny draft cell, its files joined as a
    run's reference joins them: float32 fails ``distance_gap`` with its
    counts exact, the forward strand and half the pairs fail the
    counts."""
    from portbench import control

    root = join_root(str(tmp_path))
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        r = control.readings("draft.divergent", seed, "cpu", root=root)
        assert r["float32"]["distance_gap"] > run.LIMITS["distance_gap"], r
        assert r["float32"]["count_cells_off"] == 0, r
        assert r["forward_strand"]["count_cells_off"] > 0, r
        assert r["half_pairs"]["count_cells_off"] > 0, r

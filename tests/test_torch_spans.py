"""andix_torch's spans (``andix_torch.spans``), on the CPU: nesting and
parents across worker threads, one request id a CLI call, self times,
the recorder switched off, the upload and readback counters, and the
phase file of CLI runs: its labels line for line, read by the
benchmark's parser, and its phases with the rest of the call's wall."""

import collections
import contextlib
import io
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

from andix_torch import cli, parallel, spans
from andix_torch.chain import segdrive
from andix_torch.esa import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import phases  # noqa: E402

torch.set_num_threads(2)
NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """Tracing on, into a phase file under ``tmp_path``, with no request
    kept yet; the file's path."""
    path = tmp_path / "phases.txt"
    monkeypatch.setenv("ANDIX_PROF_FILE", str(path))
    monkeypatch.setattr(spans, "REQUESTS", collections.deque(maxlen=64))
    return path


def _family(tmp_path, length=6000, clonal=False):
    """Three genomes as FASTA files: g0 random, g1 at 0.02 (g0 itself
    when ``clonal``), g2 at 0.04."""
    r = np.random.default_rng(7)
    base = NUCL[r.integers(0, 4, length)]
    paths = []
    for k in range(3):
        codes = np.searchsorted(NUCL, base)
        hit = r.random(length) < 0.02 * k
        seq = base if clonal and k == 1 else NUCL[(codes + np.where(
            hit, r.integers(1, 4, length), 0)) % 4]
        path = tmp_path / f"g{k}.fa"
        path.write_text(f">g{k}\n" + seq.tobytes().decode() + "\n")
        paths.append(str(path))
    return paths


def _cli(paths):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        code = cli.main(["--backend", "cpu", "--progress=never"] + paths)
    return code, out.getvalue()


def test_spans_nest_under_their_parents_and_share_the_request(traced):
    """A span's parent is the innermost open span of its thread; a worker
    thread's ``worker`` span nests under the caller's open span, and its
    spans under it; every span of the call has the call's request."""
    before = len(spans.REQUESTS)
    with spans.request():
        with spans.span("subjects") as outer:
            with spans.span("joint.text") as inner:
                assert spans.current() is inner
            assert spans.current() is outer
            parallel.run_workers(
                [lambda: spans.span("sx.text").end()] * 2,
                [torch.device("cpu")] * 2)
        with spans.request():  # inside an open request: nothing new
            spans.span("fasta.read").end()
    assert spans.current() is None
    assert len(spans.REQUESTS) == before + 1
    req = spans.REQUESTS[-1]
    by_name = {}
    for s in req["spans"]:
        by_name.setdefault(s["name"], []).append(s)
    outer, inner = by_name["subjects"][0], by_name["joint.text"][0]
    assert outer["parent"] is None and inner["parent"] == outer["id"]
    workers = by_name["worker"]
    assert [w["parent"] for w in workers] == [outer["id"]] * 2
    assert [w["device"] for w in workers] == ["cpu", "cpu"]
    assert sorted(s["parent"] for s in by_name["sx.text"]) == sorted(
        w["id"] for w in workers)
    assert {w["thread"] for w in workers} == {
        s["thread"] for s in by_name["sx.text"]}
    assert threading.get_ident() not in {w["thread"] for w in workers}
    assert by_name["fasta.read"][0]["parent"] is None
    assert all(s["t0"] <= s["t1"] for s in req["spans"])
    assert not traced.exists(), "no phase ran, so no line is written"


def test_each_cli_call_is_one_request(traced, tmp_path):
    paths = _family(tmp_path)
    before = len(spans.REQUESTS)
    ids = []
    for _ in range(2):
        assert _cli(paths)[0] == 0
        ids.append(spans.REQUESTS[-1]["id"])
    assert len(spans.REQUESTS) == before + 2 and ids[0] != ids[1]


@pytest.mark.parametrize("kids, want", [
    ([], 100),
    ([(10, 30)], 80),
    ([(10, 30), (20, 50), (60, 70)], 50),  # overlapping children
    ([(20, 50), (10, 30), (30, 40)], 60),  # in any order, one inside
    ([(90, 120), (-5, 5)], 85),  # clipped to the parent
    ([(0, 100), (40, 60)], 0),
])
def test_self_time(kids, want):
    """A span's self time is its duration less the part its children
    cover; a child's own self time is its duration."""
    tree = [{"id": 1, "parent": None, "t0": 0, "t1": 100}] + [
        {"id": 2 + k, "parent": 1, "t0": a, "t1": b}
        for k, (a, b) in enumerate(kids)]
    got = spans.self_ns(tree)
    assert got[1] == want
    assert all(got[2 + k] == b - a for k, (a, b) in enumerate(kids))


def test_off_makes_nothing(tmp_path, monkeypatch):
    """With ``ANDIX_PROF_FILE`` unset a CLI call makes no span object and
    no event, keeps no request and writes no file; ``span`` gives the one
    shared null span, ``count`` and the copies do nothing else."""
    monkeypatch.delenv("ANDIX_PROF_FILE", raising=False)

    def refuse(*a, **kw):
        raise AssertionError("made while tracing is off")

    monkeypatch.setattr(spans, "Span", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    paths = _family(tmp_path)
    before = list(spans.REQUESTS)
    assert _cli(paths)[0] == 0
    assert list(spans.REQUESTS) == before
    assert sorted(os.listdir(tmp_path)) == ["g0.fa", "g1.fa", "g2.fa"]
    assert spans.span("joint.upload", "cpu") is spans.NULL
    assert spans.span("no such span") is spans.NULL and not spans.NULL
    assert spans.current() is None
    spans.count("wait_ns", 5)
    a = np.arange(4, dtype=np.int32)
    assert spans.upload(a, "cpu").tolist() == [0, 1, 2, 3]
    assert spans.readback(torch.ones(2)).tolist() == [1.0, 1.0]


def test_upload_and_readback_count_on_the_innermost_span(traced):
    """``upload`` counts the bytes and host nanoseconds of a copy off the
    host (the meta device stands in for a card), none for a copy that
    stays on it; ``readback`` counts its host nanoseconds; counts made
    outside every span go to the request."""
    a = np.arange(1000, dtype=np.int32)
    with spans.request():
        with spans.span("walk.dispatch"):
            with spans.span("sx.text"):
                spans.upload(a, "meta")
                spans.upload(torch.from_numpy(a), "meta")
            assert spans.readback(torch.arange(3)).tolist() == [0, 1, 2]
            spans.upload(a, "cpu")
            spans.count("walk.events", 7)
        spans.upload(a, "meta")
        with pytest.raises(ValueError):
            spans.span("no such span")
    req = spans.REQUESTS[-1]
    dispatch, text = req["spans"]
    assert text["counts"]["h2d_bytes"] == 8000
    assert text["counts"]["upload_ns"] > 0
    assert set(dispatch["counts"]) == {"wait_ns", "walk.events"}
    assert dispatch["counts"]["walk.events"] == 7
    assert req["counts"]["h2d_bytes"] == 4000


# what the phase file holds for each case, line for line (the labels of
# the phase lines before the spans, numbers by pattern)
N = r"\d+"
JOINT_BUILD = [rf"H2D text \({N} padded symbols\)",
               rf"SA doubling \({N} levels, buffer {N}\)", "LCP hybrid",
               r"block tables \(segid\+isa\+tq\+rmq\)",
               r"subject tables \(3 subj\)"]
UNSEGMENTED = [rf"anchor chain dispatch \(3 subj, {N} loop iters, {N} "
               r"events\)", rf"host count from {N} events"]
SX = [r"sx: query words H2D",
      rf"sx: index build \(3 subj, {N} host LCP round trips after a level "
      r"overflow\)"]
CASES = {
    "joint": ({"ANDIX_INDEX": "joint"}, {}, JOINT_BUILD + UNSEGMENTED),
    "joint_segmented": (
        {"ANDIX_INDEX": "joint", "ANDIX_CHAIN_SEGMENTS": "2"}, {},
        JOINT_BUILD + [rf"segmented walk: {N} dispatches, {N} probe steps, "
                       rf"{N} events", rf"host count from {N} events"]),
    "subject": ({"ANDIX_INDEX": "subject"}, {}, SX + [
        rf"sx: segmented walk: {N} dispatches, {N} probe steps, {N} events",
        rf"sx: host count from {N} events"]),
    "event_overflow": (
        {"ANDIX_INDEX": "joint", "ANDIX_CHAIN_SEGMENTS": "2",
         "ANDIX_EVENT_CAP": "4"}, {},
        JOINT_BUILD + ["event buffer of 4 overflowed: to the count-in-loop "
                       "replay",
                       rf"count-in-loop replay \(3 subj, {N} probe steps\)"]),
    "replay": ({"ANDIX_INDEX": "joint", "ANDIX_REPLAY": "loop"}, {},
               JOINT_BUILD + [rf"count-in-loop replay \(3 subj, {N} probe "
                              r"steps\)"]),
    "host_lcp": ({"ANDIX_INDEX": "joint"}, {"budget": 3},
                 JOINT_BUILD[:2] + ["host LCP round trip"] + JOINT_BUILD[3:]
                 + UNSEGMENTED),
    "level_overflow": ({"ANDIX_INDEX": "joint"}, {"budget": 6, "clonal": 1},
                       JOINT_BUILD[:2] + ["LCP hybrid: level overflow",
                                          "host LCP round trip"]
                       + JOINT_BUILD[3:] + UNSEGMENTED),
    "stalled": ({"ANDIX_INDEX": "subject"}, {"chunk": 4, "clonal": 1},
                SX + ["sx: walk stalled at the chunk cap: to the joint "
                      "schedule"] + JOINT_BUILD + UNSEGMENTED),
}


# the cases whose group the segmented driver walks (once)
DRIVEN = {"joint_segmented": 1, "subject": 1, "event_overflow": 1,
          "stalled": 1}


@pytest.mark.parametrize("case", list(CASES))
def test_phase_file_lines(case, traced, tmp_path, monkeypatch):
    """A CLI run writes each phase line its phase span stands for, in the
    labels the program wrote before it had spans; the benchmark's parser
    reads every line; and the phases, the FASTA read and the subjects'
    set-up neither overlap nor pass the call's wall: with the rest of it
    they sum to the wall within 1%."""
    env, patch, want = CASES[case]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if "budget" in patch:
        monkeypatch.setattr(backend, "level_budget",
                            lambda n, b: patch["budget"])
    if "chunk" in patch:
        monkeypatch.setattr(segdrive, "CHUNK_ITERS", patch["chunk"])
        monkeypatch.setattr(segdrive, "CHUNK_ITERS_MAX", patch["chunk"])
    paths = _family(tmp_path, clonal="clonal" in patch)
    monkeypatch.delenv("ANDIX_PROF_FILE")
    code, plain = _cli(paths)
    monkeypatch.setenv("ANDIX_PROF_FILE", str(traced))
    assert _cli(paths) == (code, plain) and code == 0

    lines = traced.read_text().splitlines()
    assert len(lines) == len(want), lines
    for line, label in zip(lines, want):
        assert re.fullmatch(rf"\[cpu\] {label}: \d+\.\d{{6}}s", line), line
    parsed = phases.parse(traced.read_text())
    assert [label for label, _ in parsed] == [
        line.split("] ", 1)[1].rsplit(": ", 1)[0] for line in lines]

    req = spans.REQUESTS[-1]
    wall = req["t1"] - req["t0"]
    top = [(s["t1"] - s["t0"], s["t0"], s["t1"]) for s in req["spans"]
           if s["name"] in ("fasta.read", "subjects")]
    ends = [(s["seconds"] * 1e9, max(s["t1"], s["d1"] or 0))
            for s in req["spans"] if s["name"] in spans.LABELS]
    top += [(sec, end - sec, end) for sec, end in ends]
    total = sum(length for length, _, _ in top)
    covered, reach = 0, req["t0"]
    for _, a, b in sorted(top, key=lambda x: x[1]):
        a, b = max(a, reach), min(b, req["t1"])
        if b > a:
            covered, reach = covered + b - a, b
    residual = wall - covered
    assert all(req["t0"] <= a <= b <= req["t1"] + 1000 for _, a, b in top)
    assert abs(total + residual - wall) <= 0.01 * wall

    # each segmented walk of a group counts its driver on its walk span
    driven = [s["counts"].get("walk.driver_native", 0) for s in req["spans"]
              if s["name"] in ("joint.walk", "sx.walk")]
    assert sum(driven) == DRIVEN.get(case, 0), driven


def _drafts(tmp_path, contigs=(1, 4, 7)):
    """Three genomes of 6 kbp as draft assemblies, one file a genome with
    ``contigs[k]`` records (``portbench.family.write_assembly``)."""
    from portbench import family

    seqs = family.make_family(len(contigs), 6000, [0.02, 0.04], 11)
    paths = []
    for k, (seq, c) in enumerate(zip(seqs, contigs)):
        paths += family.write_assembly(
            str(tmp_path), [seq], {"contigs": c, "min_contig": 300,
                                   "reverse_share": 0.5,
                                   "order": "longest_first"}, 11 + k)
    return paths


def _counted(req, name):
    return (sum(s["counts"].get(name, 0) for s in req["spans"])
            + req["counts"].get(name, 0))


def test_join_opens_one_span_a_file_and_one_a_subject(traced, tmp_path,
                                                      monkeypatch):
    """Under ``-j`` each file's read is one ``ingest.join`` span inside
    ``fasta.read``, its ``records`` the file's records and ``bytes`` the
    joined length, and the records and joiners are counted; each genome's
    subject, made on the host, is one ``subjects.host`` span inside
    ``subjects``.  The matrix is the one printed with tracing off."""
    paths = _drafts(tmp_path)
    records = [open(p, "rb").read().count(b">") for p in paths]
    assert records == [1, 4, 7]
    monkeypatch.delenv("ANDIX_PROF_FILE")
    plain = _cli(["-j"] + paths)
    monkeypatch.setenv("ANDIX_PROF_FILE", str(traced))
    assert _cli(["-j"] + paths) == plain and plain[0] == 0

    req = spans.REQUESTS[-1]
    by_name = {}
    for s in req["spans"]:
        by_name.setdefault(s["name"], []).append(s)
    (read,), (subjects,) = by_name["fasta.read"], by_name["subjects"]
    joins = by_name["ingest.join"]
    assert [s["attrs"]["records"] for s in joins] == records
    assert [s["attrs"]["bytes"] for s in joins] == [6000 + r - 1
                                                    for r in records]
    assert all(s["parent"] == read["id"] for s in joins)
    assert _counted(req, "join.records") == 12
    assert _counted(req, "join.joiners") == 9
    hosts = by_name["subjects.host"]
    assert [s["attrs"]["symbols"] for s in hosts] == [
        6000 + r - 1 for r in records]
    assert all(s["parent"] == subjects["id"] for s in hosts)
    assert _counted(req, "subjects.host_rs") == 3
    assert _counted(req, "subjects.device_rs") == 0


def test_one_record_files_on_the_card_route_open_neither(traced, tmp_path,
                                                         monkeypatch):
    """One record a file, read on the card's route (its plain version
    here): no ``ingest.join`` and no ``subjects.host`` span, and every
    subject counted in ``subjects.device_rs``."""
    from andix_torch import ingest

    monkeypatch.setattr(ingest, "card", lambda ctx: torch.device("cpu"))
    paths = _family(tmp_path)
    assert _cli(paths)[0] == 0
    req = spans.REQUESTS[-1]
    names = {s["name"] for s in req["spans"]}
    assert "fasta.read" in names and "subjects" in names
    assert not names & {"ingest.join", "subjects.host"}
    assert _counted(req, "subjects.device_rs") == 3
    assert _counted(req, "subjects.host_rs") == 0
    assert _counted(req, "ingest.device_files") == 3


def test_join_files_on_the_card_route_open_neither(traced, tmp_path,
                                                   monkeypatch):
    """Under ``-j`` with the files read on the card's route (its plain
    version here), the host opens neither a per-file join read nor a
    host-made RS: the card's read of the three files is one ``ingest.join``
    span inside ``fasta.read`` (the files' ``records`` and joined
    ``bytes``), which counts them in ``join.device_files`` and their
    records and joiners as the host path counts them; each subject, its
    RS the card's, is one ``subjects.host`` span inside ``subjects`` (the
    host's part) and counts in ``subjects.device_rs``.  The readers of
    ``join.read_s``, ``subjects.host_s`` and ``join.device_share`` read
    them."""
    from andix_torch import ingest
    from portbench.run import ROOT, load_metric

    paths = _drafts(tmp_path)
    plain = _cli(["-j"] + paths)
    monkeypatch.setattr(ingest, "card", lambda ctx: torch.device("cpu"))
    assert _cli(["-j"] + paths) == plain and plain[0] == 0
    req = spans.REQUESTS[-1]
    by_name = {}
    for s in req["spans"]:
        by_name.setdefault(s["name"], []).append(s)
    (read,), (subjects,) = by_name["fasta.read"], by_name["subjects"]
    (join,) = by_name["ingest.join"]
    assert join["parent"] == read["id"]
    assert join["attrs"] == {"records": 12, "bytes": 18000 + 12 - 3}
    assert {k: v for k, v in join["counts"].items()
            if k.startswith("join.")} == {
        "join.device_files": 3, "join.records": 12, "join.joiners": 9}
    hosts = by_name["subjects.host"]
    assert [s["attrs"]["symbols"] for s in hosts] == [6000, 6003, 6006]
    assert all(s["parent"] == subjects["id"] for s in hosts)
    assert _counted(req, "join.device_files") == 3
    assert _counted(req, "ingest.device_files") == 3
    assert _counted(req, "join.records") == 12
    assert _counted(req, "join.joiners") == 9
    assert _counted(req, "subjects.device_rs") == 3
    assert _counted(req, "subjects.host_rs") == 0
    record = {"phase_matrices": [{"wall_s": 1.0, "phases": []}]}
    for name in ("join.read_s", "subjects.host_s"):
        got = load_metric(ROOT, name)(record)
        assert got is not None and got > 0, name
    assert load_metric(ROOT, "join.device_share")(record) == 1.0


def test_the_join_and_subject_names_are_known():
    """The new spans and counters are named in ``NAMES``, and none of
    them is a phase with a line of its own."""
    new = {"ingest.join", "subjects.host", "join.records", "join.joiners",
           "join.device_files", "subjects.host_rs", "subjects.device_rs"}
    assert new <= spans.NAMES
    assert not new & set(spans.LABELS)

"""The FASTA ingest and the joint block's text (``andix_torch.ingest``),
on the CPU: the ingest kernels' host twin against their plain version,
with and without join mode; ``ingest.read`` through the plain version
against ``fasta.read_fasta`` and ``sequence.subject_init`` on fuzzed
files, every malformed file on the host with today's message; in join
mode through the plain version and the twin against
``fasta.read_fasta_join``; ``block_text`` and ``block_layout`` against
``pad_symbols`` and ``joint.build_block``; the counters; and the CLI
with the card's read path on the CPU against the host's read, byte for
byte, with and without ``-j``."""

import collections
import contextlib
import io

import numpy as np
import pytest
import torch

from andix_torch import cli, fasta, ingest, spans
from andix_torch.esa import joint
from andix_torch.esa.backend import bucket, pad_symbols
from andix_torch.runtime import Context
from andix_torch.sequence import catcomp, join, normalize, subject_init

torch.set_num_threads(2)
NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
CPU = torch.device("cpu")


def _pick(rng, alphabet: bytes, n: int) -> bytes:
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), n)].tobytes()


def _fuzz_file(rng) -> bytes:
    """A well-formed FASTA file of 1-4 records: names of any non-blank
    bytes, comments after a space, tab, vertical tab or CR, sequences of
    upper and lower case, N and IUPAC letters, '-' and '*', in lines of
    1-90 bytes ended by LF or CRLF, with blank lines, spaces and tabs
    inside lines, and with or without a last newline."""
    out = []
    for _ in range(int(rng.integers(1, 5))):
        head = b">" + _pick(rng, b"abcXYZ019_|.>:\xe9\x80",
                            int(rng.integers(1, 7)))
        if rng.random() < 0.6:
            head += _pick(rng, b" \t\v\r", 1) + _pick(
                rng, b"ab c\t>!1\xe9 -", int(rng.integers(0, 10)))
        out.append(head + (b"\r\n" if rng.random() < 0.2 else b"\n"))
        letters = _pick(rng, b"ACGTACGTACGTacgtNnRYKMSWbdhv-*",
                        int(rng.integers(1, 400)))
        width = int(rng.integers(1, 91))
        lines = [letters[k: k + width] for k in range(0, len(letters), width)]
        for k, line in enumerate(lines):
            if rng.random() < 0.1:
                cut = int(rng.integers(0, len(line) + 1))
                line = line[:cut] + _pick(rng, b" \t", 1) + line[cut:]
            end = [b"\n", b"\r\n", b"\n\n", b" \n"][int(rng.integers(0, 4))]
            out.append(line + (end if k + 1 < len(lines) else b"\n"))
    blob = b"".join(out)
    return blob if rng.random() < 0.8 else blob.rstrip(b"\n")


def _host_read(paths):
    ctx, err = Context(), io.StringIO()
    with contextlib.redirect_stderr(err):
        seqs = [s for p in paths for s in fasta.read_fasta(p, ctx)]
    return seqs, ctx, err.getvalue()


def _card_read(paths):
    ctx, err = Context(), io.StringIO()
    with contextlib.redirect_stderr(err):
        seqs = ingest.read(paths, ctx, CPU)
    return seqs, ctx, err.getvalue()


def _write(tmp_path, blobs):
    paths = []
    for k, blob in enumerate(blobs):
        p = tmp_path / f"f{k}.fa"
        p.write_bytes(blob)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("seed", range(6))
def test_read_equals_the_host_read_on_fuzzed_files(tmp_path, seed):
    """Well-formed files, several a call: every file on the card's path,
    and names, comments, sequences, non-ACGT flags, RS, G+C and thresholds
    exactly the host's."""
    rng = np.random.default_rng(seed)
    for trial in range(12):
        blobs = [_fuzz_file(rng) for _ in range(int(rng.integers(1, 4)))]
        paths = _write(tmp_path, blobs)
        want, ctx_h, err_h = _host_read(paths)
        got, ctx_d, err_d = _card_read(paths)
        assert (err_d, ctx_d.non_acgt) == (err_h, ctx_h.non_acgt)
        assert all(type(s) is ingest.IngestSeq for s in got)
        assert [s.name for s in got] == [s.name for s in want]
        records = ingest.read_records(paths, CPU)
        assert sorted(records) == list(range(len(paths)))
        flat = [r for k in sorted(records) for r in records[k]]
        raw = [r for blob in blobs for r in fasta.parse_fasta_bytes(blob)[0]]
        for a, b, r, rec in zip(want, got, raw, flat):
            assert np.array_equal(a.data, b.data)
            assert (rec.name, rec.comment) == (r.name, r.comment)
            assert rec.non_acgt == normalize(r.data)[1]
            if len(a.data):
                sa, sb = subject_init(a, 0.025), ingest.subject(b, 0.025)
                assert np.array_equal(sa.rs, sb.rs)
                assert (sa.gc, sa.threshold) == (sb.gc, sb.threshold)


def _twin_scan(raw, cap, starts=None):
    return ingest.scan_cpu_twin(raw, cap, False, None, starts)[:3]


def _host_join_read(paths):
    ctx, err = Context(), io.StringIO()
    ctx.join = True
    with contextlib.redirect_stderr(err):
        seqs = [s for p in paths for s in fasta.read_fasta_join(p, ctx)]
    return seqs, ctx, err.getvalue()


def _card_join_read(paths):
    ctx, err = Context(), io.StringIO()
    ctx.join = True
    with contextlib.redirect_stderr(err):
        seqs = ingest.read(paths, ctx, CPU)
    return seqs, ctx, err.getvalue()


# join-mode files by name: several records with lower case and N runs and
# one that keeps no ACGT byte ('!!' in the joined text), one record (no
# joiner), a file the gate refuses (an empty name: the host's message and
# the records before it), names with no dot, several dots, a leading dot
JOIN_FILES = {
    "multi.fa": b">a x\nACGTacgtNN\nnnGG\n>b\nNNNN\n>c y z\nTTGCA\n",
    "one_record": b">one\nACGTTTGCA\n",
    "refused.fa": b">q\nACGTT\n>\nAC\n",
    "a.b.c.fa": b">z\nNNNN\n>y\nccccNNNNtt\n>x\nA\n",
    ".hidden.fa": b">h\nGATTACA\n>i\nacgtRYacgt\n",
}


@pytest.mark.parametrize("route", ["plain", "twin"])
@pytest.mark.parametrize("seed", range(3))
def test_join_read_equals_the_host_join_read(tmp_path, monkeypatch, route,
                                             seed):
    """Join mode (``ctx.join``), several files a call, in shuffled order
    among fuzzed files of 1-4 records: every file the gate takes is one
    ``IngestSeq`` whose name, joined sequence, RS, G+C and threshold are
    ``fasta.read_fasta_join`` + ``subject_init``'s; the refused file keeps
    the host's path, its message and its place; the non-ACGT flag is the
    host's.  Through the plain version and the kernels' host twin."""
    if route == "twin":
        monkeypatch.setattr(ingest, "scan", _twin_scan)
    rng = np.random.default_rng(300 + seed)
    files = dict(JOIN_FILES)
    for k in range(4):
        files[f"fuzz{k}.x.fa"] = _fuzz_file(rng)
    order = rng.permutation(len(files))
    names = [list(files)[i] for i in order]
    paths = []
    for name in names:
        p = tmp_path / name
        p.write_bytes(files[name])
        paths.append(str(p))
    want, ctx_h, err_h = _host_join_read(paths)
    got, ctx_d, err_d = _card_join_read(paths)
    assert "refused.fa: Empty name on line 3." in err_h
    assert (err_d, ctx_d.non_acgt) == (err_h, ctx_h.non_acgt)
    assert [type(s) is ingest.IngestSeq for s in got] == [
        n != "refused.fa" for n in names]
    assert [s.name for s in got] == [s.name for s in want]
    assert {"multi", "one_record", "a", ""} <= {s.name for s in got}
    for a, b in zip(want, got):
        assert np.array_equal(a.data, b.data), a.name
        sa, sb = subject_init(a, 0.025), ingest.subject(b, 0.025)
        assert np.array_equal(sa.rs, sb.rs)
        assert (sa.gc, sa.threshold) == (sb.gc, sb.threshold)
    joined = {s.name: s.data.tobytes() for s in got}
    assert joined["multi"] == b"ACGTACGTGG!!TTGCA"
    assert joined["a"] == b"!CCCCTT!A"


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_twin_equals_plain_in_join_mode(seed, tiny):
    """The RS pass in join mode, host twin against plain version, on
    random bytes of every class with random file starts (ascending, the
    first at 0 or not, some owning no header): the kept bytes, the table
    and every RS byte."""
    rng = np.random.default_rng(200 + seed)
    alphabet = np.frombuffer(b"ACGTacgtNn-*> \t\r\n\n\n1!\x00\xff", np.uint8)
    for trial in range(8):
        m = int(rng.integers(1, 60_000))
        x = alphabet[rng.integers(0, len(alphabet), m)]
        if trial % 2:
            x[0] = ord(">")
        raw = torch.from_numpy(x)
        cap = int(rng.integers(1, 400))
        cut = rng.integers(0, m, int(rng.integers(1, 12)))
        if trial % 4 != 3:
            cut = np.append(cut, 0)
        starts = torch.from_numpy(np.unique(cut).astype(np.int64))
        seq, rec, rs, _ = ingest.scan_cpu_twin(raw, cap, tiny, None, starts)
        want = ingest.scan_plain(raw, cap, starts)
        assert torch.equal(rec, want[1])
        k, nh = int(rec[cap, 2]), int(rec[cap, 0])
        assert torch.equal(seq[:k], want[0][:k])
        if nh <= cap:
            total = 2 * k + 2 * nh
            assert torch.equal(rs[:total], want[2][:total])


def test_plain_join_scan_of_files_in_lines():
    """Three files of contigs in 70-column lines, one RS a file: each is
    ``catcomp`` of ``sequence.join`` of its normalized records, followed
    by a 0, and starts where its first record's RS would."""
    rng = np.random.default_rng(4)
    lens = [(1, 69, 70), (71,), (10_000, 0, 3)]
    blobs, joins = [], []
    for f, group in enumerate(lens):
        recs = [NUCL[rng.integers(0, 4, n)] for n in group]
        blobs.append(b"".join(
            b">f%dc%d\n" % (f, k) + (b"\n".join(
                s[j: j + 70].tobytes() for j in range(0, len(s), 70))
                or b"NN") + b"\n" for k, s in enumerate(recs)) + b"\n")
        joins.append(join(recs))
    raw = np.frombuffer(b"".join(blobs), np.uint8).copy()
    starts = np.cumsum([0] + [len(b) for b in blobs[:-1]])
    seq, rec, rs = ingest.scan_plain(torch.from_numpy(raw), 8,
                                     torch.from_numpy(starts))
    off = 0
    for j in joins:
        want = catcomp(j)
        assert np.array_equal(rs[off: off + len(want)].numpy(), want)
        assert int(rs[off + len(want)]) == 0
        off += len(want) + 1
    assert off == 2 * int(rec[8, 2]) + 2 * int(rec[8, 0])


GOOD = b">g1 first\nACGTACGTAC\nGGTT\n"


@pytest.mark.parametrize("bad", [
    b"ACGT\n>g2\nACGT\n",             # no leading '>'
    b"\n>g2\nACGT\n",                  # '>' not at the file's start
    b">\nACGT\n",                      # empty name
    b"> g2\nACGT\n",                   # blank after '>'
    b">g2\n>g3\nACGT\n",               # empty sequence
    b">g2\nACGT\n>g3\n",               # empty last sequence
    b">g2\nAC>GT\n",                   # '>' mid-line
    b">g2\nACGT\n >g3\nACGT\n",        # '>' after a blank
    b">g2\nAC1GT\n",                   # a digit
    b">g2\nAC!GT\n",                   # '!'
    b">g2\nAC\xc3\xa9GT\n",            # high bytes
    b">g2\nAC\x00GT\n",                # a NUL
    b">g2",                            # EOF in the name
    b">g2 comment",                    # EOF in the header
    b">g2\nACGT\n>g3 x",               # EOF in a later header
    b"",                               # empty
])
def test_malformed_files_take_the_host_path(tmp_path, bad):
    """Every file outside the gate is read by ``fasta.read_fasta``, with
    today's message and partial records; the good file beside it still
    takes the card's path."""
    paths = _write(tmp_path, [GOOD, bad, GOOD])
    want, ctx_h, err_h = _host_read(paths)
    got, ctx_d, err_d = _card_read(paths)
    assert (err_d, ctx_d.exit_code, ctx_d.non_acgt) == (
        err_h, ctx_h.exit_code, ctx_h.non_acgt)
    assert [s.name for s in got] == [s.name for s in want]
    for a, b in zip(want, got):
        assert np.array_equal(a.data, b.data)
    assert sorted(ingest.read_records(paths, CPU)) == [0, 2]


def test_stdin_missing_and_directories_take_the_host_path(tmp_path):
    paths = _write(tmp_path, [GOOD])
    names = [paths[0], str(tmp_path / "missing.fa"), str(tmp_path)]
    want, _, err_h = _host_read(names)
    got, _, err_d = _card_read(names)
    assert err_d == err_h and "missing.fa" in err_h
    assert [s.name for s in got] == [s.name for s in want]
    assert sorted(ingest.read_records(names + ["-"], CPU)) == [0]


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_twin_equals_plain(seed, tiny):
    """The kernels' bodies under g++ (tiles of 16384 bytes, or 256 with
    ``tiny``; some tiles publishing only their aggregate, so look-backs
    fold across them) against the plain version: kept bytes, the record
    table and totals, RS bytes; tables too small for the headers leave
    the totals right and no RS."""
    rng = np.random.default_rng(100 + seed)
    alphabet = np.frombuffer(b"ACGTacgtNn-*> \t\r\n\n\n1!\x00\xff", np.uint8)
    for trial in range(8):
        m = int(rng.integers(1, 60_000))
        x = alphabet[rng.integers(0, len(alphabet), m)]
        if trial % 2:
            x[0] = ord(">")
        raw = torch.from_numpy(x)
        cap = int(rng.integers(1, 200))
        tiles = ingest.scan_cpu_tiles(m, tiny)
        agg = torch.from_numpy(rng.random(tiles) < 0.5) if trial % 3 else None
        seq, rec, rs, status = ingest.scan_cpu_twin(raw, cap, tiny, agg)
        want = ingest.scan_plain(raw, cap)
        assert torch.equal(rec, want[1])
        k, nh = int(rec[cap, 2]), int(rec[cap, 0])
        assert torch.equal(seq[:k], want[0][:k])
        if nh <= cap:
            total = 2 * k + 2 * nh
            assert torch.equal(rs[:total], want[2][:total])
        if agg is not None:
            assert torch.equal(status == 2, ~agg)


def test_plain_scan_of_a_family_in_lines():
    """Records of whole 70-column genomes: the table's rows, the kept
    bytes and each RS equal ``catcomp`` of the normalized sequence."""
    rng = np.random.default_rng(3)
    seqs = [NUCL[rng.integers(0, 4, n)] for n in (1, 69, 70, 71, 10_000)]
    blob = b"".join(
        b">s%d\n" % k + b"\n".join(s[j: j + 70].tobytes()
                                   for j in range(0, len(s), 70)) + b"\n"
        for k, s in enumerate(seqs))
    seq, rec, rs = ingest.scan_plain(torch.from_numpy(
        np.frombuffer(blob, np.uint8).copy()), 8)
    assert int(rec[8, 0]) == len(seqs)
    off = 0
    for k, s in enumerate(seqs):
        want = catcomp(s)
        assert np.array_equal(rs[off: off + len(want)].numpy(), want)
        assert int(rs[off + len(want)]) == 0
        off += len(want) + 1


def _layouts(rng):
    out = []
    for ns, nq in ((1, 0), (3, 0), (2, 2), (0, 1), (1, 3)):
        srs = {int(g): catcomp(NUCL[rng.integers(0, 4, int(n))])
               for g, n in zip(rng.permutation(9)[:ns],
                               rng.integers(0, 3000, ns))}
        qs = {10 + k: NUCL[rng.integers(0, 4, int(rng.integers(1, 2000)))]
              for k in range(nq)}
        out.append((srs, qs))
    return out


@pytest.mark.parametrize("unpadded", [False, True])
def test_block_text_equals_pad_symbols(unpadded):
    """Plain version and host twin of ``block_text`` against
    ``pad_symbols(layout.sym, padded_n)`` on random layouts (query-only
    segments, one segment, ``padded_n == n``); every separator's 0 is
    counted and no other."""
    rng = np.random.default_rng(5)
    for srs, qs in _layouts(rng):
        layout = joint.build_block(srs, qs)
        padded = layout.n if unpadded else bucket(layout.n, 1024)
        want = pad_symbols(layout.sym, padded)
        ends = torch.from_numpy(layout.seg_start[1:] - 1)
        for fn in (ingest.block_text, ingest.block_text_cpu_twin):
            sym, counts = fn(torch.from_numpy(layout.u8), ends, padded)
            assert np.array_equal(sym.numpy(), want)
            assert counts.tolist() == [len(ends), 0]


def test_block_text_counts_zero_bytes_off_the_separators():
    text = torch.tensor([65, 0, 67, 0, 71, 0], dtype=torch.uint8)
    ends = torch.tensor([3, 5], dtype=torch.int64)
    for fn in (ingest.block_text, ingest.block_text_cpu_twin):
        assert fn(text, ends, 8)[1].tolist() == [3, 1]


def test_block_layout_equals_build_block():
    """``block_layout`` against ``joint.build_block`` field by field; on
    the RS buffer ``read`` leaves, a block of consecutive subjects is a
    view of it, and any other block a copy."""
    rng = np.random.default_rng(6)
    for srs, qs in _layouts(rng):
        want = joint.build_block(srs, qs)
        got = ingest.block_layout(srs, qs, CPU)
        for f in ("u8", "seg_start", "genome_ids", "is_subject",
                  "seq_lens"):
            a, b = getattr(want, f), getattr(got, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f

    buf = torch.from_numpy(np.frombuffer(
        b"".join(catcomp(NUCL[rng.integers(0, 4, n)]).tobytes() + b"\0"
                 for n in (5, 0, 9)), np.uint8).copy()).numpy()
    rs = {0: buf[0:11], 1: buf[12:13], 2: buf[14:33]}
    view = ingest.block_layout(rs, {}, CPU)
    assert view.u8.base is buf and view.n == 34
    for subset in ({0: rs[0], 2: rs[2]}, {2: rs[2], 1: rs[1]}):
        copy = ingest.block_layout(subset, {}, CPU)
        assert copy.u8.base is not buf
        assert np.array_equal(copy.u8, joint.build_block(subset, {}).u8)
    queried = ingest.block_layout(rs, {3: buf[6:11]}, CPU)
    assert np.array_equal(queried.u8,
                          joint.build_block(rs, {3: buf[6:11]}).u8)


def _files(counts):
    return {k: v for k, v in counts.items() if k.startswith("ingest.")}


def test_counters_count_each_file(tmp_path, monkeypatch):
    """``ingest.device_files`` and ``ingest.host_files``: one a file, on
    the ``fasta.read`` span."""
    monkeypatch.setenv("ANDIX_PROF_FILE", str(tmp_path / "phases.txt"))
    monkeypatch.setattr(spans, "REQUESTS", collections.deque(maxlen=64))
    paths = _write(tmp_path, [GOOD, b">x\nAC1\n", GOOD])
    with spans.request(), contextlib.redirect_stderr(io.StringIO()):
        with spans.span("fasta.read"):
            ingest.read(paths, Context(), CPU)
        with spans.span("fasta.read"):
            ingest.read(paths, Context(), None)
    counts = [_files(s["counts"]) for s in spans.REQUESTS[-1]["spans"]]
    assert counts == [{"ingest.device_files": 2, "ingest.host_files": 1},
                      {"ingest.host_files": 3}]


def _request_counts(req):
    """The request's ``ingest.`` and ``join.`` counters over all its spans
    (the host path counts its joins in each ``ingest.join`` span)."""
    out = collections.Counter()
    for s in req["spans"]:
        out.update({k: v for k, v in s["counts"].items()
                    if k.startswith(("ingest.", "join."))})
    return dict(out)


def test_join_counters_count_each_file(tmp_path, monkeypatch):
    """In join mode each file joined on the card counts in
    ``join.device_files`` and ``ingest.device_files``, each joined on the
    host is one ``ingest.join`` span and counts in ``ingest.host_files``,
    and the card's read of its files is one ``ingest.join`` span more,
    which counts its files in ``join.device_files``;
    ``join.records`` and ``join.joiners`` are the host path's."""
    monkeypatch.setenv("ANDIX_PROF_FILE", str(tmp_path / "phases.txt"))
    monkeypatch.setattr(spans, "REQUESTS", collections.deque(maxlen=64))
    paths = _write(tmp_path, [JOIN_FILES["multi.fa"], b">x\nAC1\n>y\nA\n",
                              JOIN_FILES["one_record"]])
    for device in (CPU, None):
        ctx = Context()
        ctx.join = True
        with spans.request(), contextlib.redirect_stderr(io.StringIO()):
            with spans.span("fasta.read"):
                ingest.read(paths, ctx, device)
    card, host = (_request_counts(r) for r in list(spans.REQUESTS)[-2:])
    assert card == {"ingest.device_files": 2, "ingest.host_files": 1,
                    "join.device_files": 2, "join.records": 6,
                    "join.joiners": 3}
    assert host == {"ingest.host_files": 3, "join.records": 6,
                    "join.joiners": 3}
    joins = [[s for s in r["spans"] if s["name"] == "ingest.join"]
             for r in list(spans.REQUESTS)[-2:]]
    assert [len(j) for j in joins] == [2, 3]
    # the card's read of its two files is the first span, and counts them
    assert joins[0][0]["counts"]["join.device_files"] == 2
    assert ["join.device_files" in s["counts"]
            for j in joins for s in j] == [True] + [False] * 4


def test_card_is_none_without_a_card_and_join_mode_resolves_it_alike(
        monkeypatch):
    """No card for the CPU or JAX backends; ``-j`` resolves the card as a
    call without it does, a card included."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    ctx = Context()
    for backend in ("cpu", "jax", "auto"):
        ctx.backend = backend
        alone = ingest.card(ctx)
        ctx.join = True
        assert ingest.card(ctx) == alone
        ctx.join = False
    ctx.backend = "cpu"
    assert ingest.card(ctx) is None
    ctx.backend = "jax"
    assert ingest.card(ctx) is None
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(ingest, "resolve_devices", lambda backend: [cuda])
    ctx.backend, ctx.join = "auto", True
    assert ingest.card(ctx) == cuda


@pytest.mark.parametrize("flags", [[], ["-l"], ["-v", "-m", "Kimura"],
                                   ["-j"]])
def test_cli_with_the_card_read_prints_the_host_bytes(
        tmp_path, monkeypatch, capfd, flags):
    """The CLI with the card's read path (its plain version) against the
    host's read: stdout, stderr and exit code byte for byte, on a family
    with a lower-case, N-holding file and a refused one; under ``-j``
    each file's genome is cut into contigs, and the card's path counts
    the files it joined and the records and joiners the host's counts."""
    join = "-j" in flags
    rng = np.random.default_rng(8)
    base = NUCL[rng.integers(0, 4, 3000)]
    blobs = []
    for k in range(4):
        data = np.where(rng.random(3000) < 0.03 * k,
                        NUCL[rng.integers(0, 4, 3000)], base).tobytes()
        if k == 2:
            data = data[:1000].lower() + b"NNRY" + data[1000:]
        if not join:
            blobs.append(b">g%d sample %d\n" % (k, k) + b"\n".join(
                data[j: j + 60] for j in range(0, len(data), 60)) + b"\n")
            continue
        cuts = [0, 300 * k + 100, 1800, len(data)]
        blobs.append(b"".join(
            b">g%dc%d sample %d\n" % (k, c, k) + b"\n".join(
                data[a: b][j: j + 60] for j in range(0, b - a, 60)) + b"\n"
            for c, (a, b) in enumerate(zip(cuts, cuts[1:]))))
    blobs.append(b">g4\n" + base[:2500].tobytes() + b"!\n")
    paths = _write(tmp_path, blobs)
    args = ["--backend", "cpu", "--progress=never"] + flags + paths
    monkeypatch.setenv("ANDIX_PROF_FILE", str(tmp_path / "phases.txt"))
    monkeypatch.setattr(spans, "REQUESTS", collections.deque(maxlen=64))
    code_h = cli.main(args)
    host = capfd.readouterr()
    monkeypatch.setattr(ingest, "card", lambda ctx: CPU)
    code_d = cli.main(args)
    card = capfd.readouterr()
    assert (code_d, card.out, card.err) == (code_h, host.out, host.err)
    host_counts, card_counts = (_request_counts(r)
                                for r in list(spans.REQUESTS)[-2:])
    if not join:
        assert (host_counts, card_counts) == (
            {"ingest.host_files": 5},
            {"ingest.device_files": 4, "ingest.host_files": 1})
        return
    assert host_counts["ingest.host_files"] == 5
    assert card_counts == {"ingest.device_files": 4, "ingest.host_files": 1,
                           "join.device_files": 4,
                           "join.records": host_counts["join.records"],
                           "join.joiners": host_counts["join.joiners"]}
    assert (host_counts["join.records"], host_counts["join.joiners"]) == (
        4 * 3 + 2, 4 * 2 + 1)

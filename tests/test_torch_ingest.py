"""The FASTA ingest and the joint block's text (``andix_torch.ingest``),
on the CPU: the ingest kernels' host twin against their plain version;
``ingest.read`` through the plain version against ``fasta.read_fasta``
and ``sequence.subject_init`` on fuzzed files, every malformed file on
the host with today's message; ``block_text`` and ``block_layout``
against ``pad_symbols`` and ``joint.build_block``; the counters; and the
CLI with the card's read path on the CPU against the host's read, byte
for byte."""

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
from andix_torch.sequence import catcomp, normalize, subject_init

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


def test_card_is_none_without_a_card_or_in_join_mode():
    ctx = Context()
    ctx.backend = "cpu"
    assert ingest.card(ctx) is None
    ctx.backend = "jax"
    assert ingest.card(ctx) is None
    ctx.backend, ctx.join = "auto", True
    assert ingest.card(ctx) is None


@pytest.mark.parametrize("flags", [[], ["-l"], ["-v", "-m", "Kimura"]])
def test_cli_with_the_card_read_prints_the_host_bytes(
        tmp_path, monkeypatch, capfd, flags):
    """The CLI with the card's read path (its plain version) against the
    host's read: stdout, stderr and exit code byte for byte, on a family
    with a lower-case, N-holding file and a refused one."""
    rng = np.random.default_rng(8)
    base = NUCL[rng.integers(0, 4, 3000)]
    blobs = []
    for k in range(4):
        data = np.where(rng.random(3000) < 0.03 * k,
                        NUCL[rng.integers(0, 4, 3000)], base).tobytes()
        if k == 2:
            data = data[:1000].lower() + b"NNRY" + data[1000:]
        blobs.append(b">g%d sample %d\n" % (k, k) + b"\n".join(
            data[j: j + 60] for j in range(0, len(data), 60)) + b"\n")
    blobs.append(b">g4\n" + base[:2500].tobytes() + b"!\n")
    paths = _write(tmp_path, blobs)
    args = ["--backend", "cpu", "--progress=never"] + flags + paths
    code_h = cli.main(args)
    host = capfd.readouterr()
    monkeypatch.setattr(ingest, "card", lambda ctx: CPU)
    monkeypatch.setenv("ANDIX_PROF_FILE", str(tmp_path / "phases.txt"))
    monkeypatch.setattr(spans, "REQUESTS", collections.deque(maxlen=64))
    code_d = cli.main(args)
    card = capfd.readouterr()
    assert (code_d, card.out, card.err) == (code_h, host.out, host.err)
    counts = [_files(s["counts"]) for s in spans.REQUESTS[-1]["spans"]
              if s["name"] == "fasta.read"]
    assert counts == [{"ingest.device_files": 4, "ingest.host_files": 1}]

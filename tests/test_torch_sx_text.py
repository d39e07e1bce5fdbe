"""The subject indexes' texts made on the device (``subject_pipeline.
_index_text``: the RS bytes, ``ingest.block_text``) against ``andix``'s
own index text, ``andix.esa.joint.build_block`` + ``andix``'s
``pad_symbols``, put through the same build: the group index tensor for
tensor on one subject, unequal lengths, a group that is not a multiple
of 8, a subject outside the block alphabet, subjects read by
``ingest.read`` (views of one buffer) and by ``fasta.read_fasta`` (no
views), and the host-LCP retreat; the counters of texts made on the
device and on the host; the packed query words against the host
concatenation they replace; and the CLI on the subject schedule, its
files read through the ingest, against ``andix``'s bytes."""

import collections
import contextlib
import io

import numpy as np
import pytest
import torch

from andix import cli as jcli
from andix.esa import joint as jjoint
from andix.esa.backend_jax import pad_symbols as jpad_symbols
from andix_torch import cli, fasta, ingest, spans
from andix_torch import subject_pipeline as sxp
from andix_torch.esa import backend
from andix_torch.esa import subject_index as si
from andix_torch.runtime import Context
from andix_torch.sequence import Seq, subject_init

torch.set_num_threads(2)

NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
CPU = torch.device("cpu")
CACHE_K = 3


def _genomes(lengths, seed, repeat=False):
    """Random relatives of one base genome, cut to ``lengths``; with
    ``repeat`` the first is a block twice over."""
    r = np.random.default_rng(seed)
    base = NUCL[r.integers(0, 4, max(lengths))]
    out = []
    for k, n in enumerate(lengths):
        codes = np.searchsorted(NUCL, base[:n])
        hit = r.random(n) < 0.02 * k
        out.append(NUCL[(codes + np.where(hit, r.integers(1, 4, n), 0))
                        % 4])
    if repeat:
        out[0] = np.concatenate([out[0][: lengths[0] // 2]] * 2)
    return out


def _fasta_files(tmp_path, genomes):
    paths = []
    for k, g in enumerate(genomes):
        p = tmp_path / f"s{k}.fa"
        data = g.tobytes()
        p.write_bytes(b">s%d\n" % k + b"\n".join(
            data[j: j + 70] for j in range(0, len(data), 70)) + b"\n")
        paths.append(str(p))
    return paths


def _seqs(tmp_path, genomes, read):
    """The genomes as the CLI reads them: ``ingest.read``'s records (views
    of one host buffer) or ``fasta.read_fasta``'s (no views)."""
    paths = _fasta_files(tmp_path, genomes)
    with contextlib.redirect_stderr(io.StringIO()):
        if read == "ingest":
            return ingest.read(paths, Context(), CPU)
        return [s for p in paths for s in fasta.read_fasta(p, Context())]


def _subjects(seqs):
    return [ingest.subject(s, 0.025) for s in seqs]


def _oracle(group, subjects, budget):
    """``_build_group_index`` with ``andix``'s index text: each subject's
    ``andix.esa.joint.build_block`` layout, padded by ``andix``'s
    ``pad_symbols``, on the host, then the same build."""
    rows = -(-len(group) // 8) * 8
    lp = max(sxp.index_length(subjects[i]) for i in group)
    salcp = torch.zeros((rows, 2, lp), dtype=torch.int32)
    sw = torch.zeros((rows, lp // 16), dtype=torch.int64)
    cache2 = torch.zeros((rows, (1 << (2 * CACHE_K)) + 1), dtype=torch.int32)
    nreal = np.ones(rows, dtype=np.int32)
    held = sum(t.numel() * t.element_size() for t in (salcp, sw, cache2))
    max_levels = max(1, backend.level_budget(lp, budget - held))
    texts, ovf = [], []
    for k, i in enumerate(group):
        layout = jjoint.build_block({i: np.asarray(subjects[i].rs)}, {})
        texts.append(jpad_symbols(layout.sym, lp))
        sym = torch.from_numpy(texts[-1])
        nreal[k] = layout.n
        sa, lcp, o, words, cache = si.build_subject_index(
            sym, layout.n, CACHE_K, backend.alphabet_ok(sym, layout.n),
            max_levels)
        salcp[k, 0], salcp[k, 1], sw[k], cache2[k] = sa, lcp, words, cache
        ovf.append(o)
    overflowed = torch.stack(ovf).numpy()
    for k in np.nonzero(overflowed)[0]:
        salcp[k, 1] = backend.host_lcp(texts[k], salcp[k, 0], 0)
    return (salcp, sw, cache2, torch.from_numpy(nreal),
            int(overflowed.sum()))


def _traced_build(group, subjects, budget, tmp_path, monkeypatch):
    """``_build_group_index`` in a traced request, and the counters of its
    ``sx.index`` span."""
    monkeypatch.setenv("ANDIX_PROF_FILE", str(tmp_path / "phases.txt"))
    monkeypatch.setattr(spans, "REQUESTS", collections.deque(maxlen=64))
    with spans.request():
        with spans.span("sx.index", CPU, subjects=len(group)) as sp:
            got = sxp._build_group_index(group, subjects, CACHE_K, CPU,
                                         budget, 0)
            sp.set(host_lcp=got[4])
    index = next(s for s in spans.REQUESTS[-1]["spans"]
                 if s["name"] == "sx.index")
    return got, {k: v for k, v in index["counts"].items()
                 if k.startswith("sx.text")}


# name: (genome lengths, the group's subjects, seed)
GROUPS = {
    "one": ([1500], [0], 1),
    "unequal": ([400, 1700, 900], [0, 1, 2], 2),
    "nine": ([300 + 50 * k for k in range(9)], list(range(9)), 3),
    "subset": ([600, 1100, 800, 700], [3, 1], 4),
}


@pytest.mark.parametrize("read", ["ingest", "fasta"])
@pytest.mark.parametrize("name", list(GROUPS))
def test_group_index_equals_andix_text(name, read, tmp_path, monkeypatch):
    """Every tensor of the group index, and the host-LCP count (0), equal
    the oracle's; ``sx.text_device`` counts each subject once and
    ``sx.text_host`` none; the ingest's subjects are texts in place."""
    lengths, group, seed = GROUPS[name]
    subjects = _subjects(_seqs(tmp_path, _genomes(lengths, seed), read))
    for i in group:
        layout = ingest.block_layout({i: subjects[i].rs}, {}, CPU)
        assert np.shares_memory(layout.u8, subjects[i].rs) == (
            read == "ingest")
    got, counts = _traced_build(group, subjects, 1 << 30, tmp_path,
                                monkeypatch)
    want = _oracle(group, subjects, 1 << 30)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[4] == want[4] == 0
    assert got[0].shape[0] == -(-len(group) // 8) * 8
    assert counts == {"sx.text_device": len(group)}


def test_subject_outside_the_block_alphabet(tmp_path, monkeypatch):
    """A subject with non-ACGT bytes (not normalized: its reverse
    complement holds letters outside the block alphabet) builds in
    ``levels`` mode, as the oracle's text does."""
    genomes = _genomes([700, 900], 5)
    genomes[1] = genomes[1].copy()
    genomes[1][100:110] = np.frombuffer(b"NNNNRYKMSW", np.uint8)
    subjects = [subject_init(Seq(g, f"s{k}"), 0.025)
                for k, g in enumerate(genomes)]
    sym, n = sxp._index_text(subjects[1].rs, sxp.index_length(subjects[1]),
                             CPU)
    assert not backend.alphabet_ok(sym, n)
    got, counts = _traced_build([0, 1], subjects, 1 << 30, tmp_path,
                                monkeypatch)
    want = _oracle([0, 1], subjects, 1 << 30)
    for a, b in zip(got, want):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    assert counts == {"sx.text_device": 2}


@pytest.mark.parametrize("read", ["ingest", "fasta"])
def test_host_lcp_retreat(read, tmp_path, monkeypatch):
    """A one-row level budget: the self-repeating subject's levels
    overflow and its LCP is taken on the host from a padded int32 text
    made there (``sx.text_host``), equal to the oracle's."""
    monkeypatch.setattr(backend, "level_budget", lambda lp, budget: 1)
    subjects = _subjects(_seqs(tmp_path, _genomes([1600, 1500, 1400], 6,
                                                  repeat=True), read))
    got, counts = _traced_build([0, 1, 2], subjects, 1 << 30, tmp_path,
                                monkeypatch)
    want = _oracle([0, 1, 2], subjects, 1 << 30)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert got[4] == want[4] >= 1
    assert counts == {"sx.text_device": 3, "sx.text_host": got[4]}


def test_index_text_raises_on_a_zero_symbol():
    """A 0 byte inside the RS is not a separator: the zero counts refuse
    it, as the joint block's text does."""
    rs = np.frombuffer(b"ACG\0T#ACGT", np.uint8)
    with pytest.raises(ValueError, match="2 zero bytes for 1 separator"):
        sxp._index_text(rs, 16, CPU)


def _concatenated_words(seqs):
    """The route ``_pack_query_words`` replaced: the queries and a 0 after
    each, concatenated on the host, 16 to 31 zeros more, one upload."""
    parts = []
    for s in seqs:
        parts += [np.asarray(s.data, np.uint8), np.zeros(1, np.uint8)]
    blob2 = np.concatenate(parts)
    blob2 = np.concatenate([blob2, np.zeros((-len(blob2)) % 16 + 16,
                                            np.uint8)])
    return si.pack_words_u8(torch.from_numpy(blob2))


@pytest.mark.parametrize("read", ["ingest", "fasta"])
@pytest.mark.parametrize("lengths", [[1], [15, 16, 17], [1000, 333, 64, 5]])
def test_query_words_equal_the_concatenation(read, lengths, tmp_path):
    seqs = _seqs(tmp_path, _genomes(lengths, 7), read)
    _, _, qw_base = sxp._host_query_blob(seqs, len(seqs))
    got = sxp._pack_query_words(seqs, qw_base, CPU)
    want = _concatenated_words(seqs)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("flags", [[], ["-m", "Kimura"]])
def test_cli_on_the_subject_schedule_reads_through_the_ingest(
        flags, tmp_path, monkeypatch, capsys):
    """Ten genomes of 2 kbp (20 kbp in all) on the subject schedule, their
    files read through the ingest (its plain version): stdout and exit
    code equal ``andix``'s, every index text made by ``block_text``."""
    monkeypatch.setenv("ANDIX_INDEX", "subject")
    monkeypatch.setenv("ANDIX_SX_MESH", "0")
    r = np.random.default_rng(9)
    base = NUCL[r.integers(0, 4, 2000)]
    genomes = [NUCL[(np.searchsorted(NUCL, base) + np.where(
        r.random(2000) < 0.01 * k, r.integers(1, 4, 2000), 0)) % 4]
        for k in range(10)]
    paths = _fasta_files(tmp_path, genomes)
    args = ["--progress=never"] + flags + paths
    code_j = jcli.main(list(args))
    out_j = capsys.readouterr().out
    monkeypatch.setattr(ingest, "card", lambda ctx: CPU)
    monkeypatch.setenv("ANDIX_PROF_FILE", str(tmp_path / "phases.txt"))
    monkeypatch.setattr(spans, "REQUESTS", collections.deque(maxlen=64))
    code_t = cli.main(["--backend", "cpu"] + args)
    out_t = capsys.readouterr().out
    assert (code_t, out_t) == (code_j, out_j)
    assert out_t.startswith("10\n")
    req = spans.REQUESTS[-1]
    counted = collections.Counter()
    for s in req["spans"]:
        counted.update(s["counts"])
    assert counted["ingest.device_files"] == 10
    assert counted["sx.text_device"] == 10
    assert counted["sx.text_host"] == 0

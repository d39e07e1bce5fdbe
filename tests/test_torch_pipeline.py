"""andix_torch joint schedule end to end on the CPU (``--backend cpu``):
the n x n count grids must equal andix's JAX backend on the joint
schedule exactly — the segmented-walk families of test_segmented.py,
blocked and query-chunked plans, event-buffer overflow (to the
count-in-loop replay) — plus checkpoint rows shared across the two
packages and the import boundary."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from andix import pipeline as jpipeline
from andix.chain import segmented as jsegmented
from andix.esa.backend_jax import JaxBackend
from andix.runtime import Context as JContext
from andix.sequence import Seq as JSeq
from andix_torch import pipeline
from andix_torch.chain import segdrive
from andix_torch.runtime import Context
from andix_torch.sequence import Seq

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)


def _family(n, length, rates, seed):
    r = np.random.default_rng(seed)
    base = NUCL[r.integers(0, 4, length)]
    out = [("g0", base)]
    for k in range(n - 1):
        codes = np.searchsorted(NUCL, base)
        hit = r.random(length) < rates[k % len(rates)]
        out.append((f"g{k + 1}", NUCL[(codes + np.where(
            hit, r.integers(1, 4, length), 0)) % 4]))
    return out


def _grid(M, n):
    return np.array([[M[i][j].counts for j in range(n)] for i in range(n)])


@pytest.fixture
def joint_schedule(monkeypatch):
    """Both packages on the joint schedule, single-process and unsharded,
    so the JAX run walks the same segmented schedule as the port."""
    monkeypatch.setenv("ANDIX_INDEX", "joint")
    monkeypatch.setenv("ANDIX_SHARDED", "0")

    def run(fam, k=None, block_syms=None, **patches):
        if k is not None:
            monkeypatch.setenv("ANDIX_CHAIN_SEGMENTS", str(k))
        for name, val in patches.items():
            monkeypatch.setattr(jsegmented, name, val)
            monkeypatch.setattr(segdrive, name, val)
        ref = jpipeline.calculate_matrix(
            [JSeq(d, nm) for nm, d in fam], JContext(), backend=JaxBackend(),
            block_syms=block_syms)
        got = pipeline.calculate_matrix(
            [Seq(d, nm) for nm, d in fam], Context(),
            [torch.device("cpu")], block_syms=block_syms)
        n = len(fam)
        assert (_grid(got, n) == _grid(ref, n)).all()
        return got

    return run


def test_k6_duplicate_and_unrelated(joint_schedule):
    fam = _family(5, 5000, [0.005, 0.05, 0.2, 0.45], seed=11)
    fam.append(("dup", fam[0][1].copy()))
    joint_schedule(fam, k=6)


def test_k16_adversarial_budgets(joint_schedule):
    fam = _family(4, 3000, [0.01, 0.12, 0.4], seed=23)
    joint_schedule(fam, k=16, CHUNK_ITERS=16, REPAIR_EVENTS=1)


def test_nonconvergence_reruns_unsegmented(joint_schedule, monkeypatch,
                                           capsys):
    """A resolve loop that never converges (one repair event, no
    fall-back, no merge: andix's merge search patched out, and the port's
    cold walks' events given s = -1 on their way to its driver, so no
    repair event meets one) makes the segmented walk return None; the
    port reruns the group with one segment per lane."""
    driver = segdrive.segmented_group_anchors

    def without_merges(walk, *rest):
        def cold_apart(arr, chunk_iters, maxev):
            ev, *out = walk(arr, chunk_iters, maxev)
            if maxev > 1 and ev.shape[1]:
                ev = ev.copy()
                ev[2] = -1
            return (ev, *out)
        return driver(cold_apart, *rest)

    monkeypatch.setattr(jsegmented, "_find_merge", lambda rep, cold: None)
    monkeypatch.setattr(segdrive, "segmented_group_anchors", without_merges)
    fam = _family(3, 3000, [0.02, 0.1], seed=7)
    joint_schedule(fam, k=4, REPAIR_EVENTS=1, MAX_EXTENSIONS=10**9)
    err = capsys.readouterr().err
    assert err.count("did not converge") == 2  # andix's and the port's


def test_joined_contigs(joint_schedule):
    fam = _family(3, 4000, [0.02, 0.1], seed=31)
    for _, d in fam:
        d[1500] = ord("!")
        d[2800] = ord("!")
    joint_schedule(fam, k=5)


def test_blocked_plan(joint_schedule):
    fam = _family(5, 1500, [0.03, 0.06, 0.1, 0.2], seed=41)
    joint_schedule(fam, block_syms=2500)


def test_query_chunks(joint_schedule, monkeypatch):
    monkeypatch.setenv("ANDIX_MAX_QUERY_SYMS", "900")
    fam = _family(6, 400, [0.05], seed=43)
    joint_schedule(fam)


def test_event_overflow_falls_back_to_loop(joint_schedule, monkeypatch):
    """An event buffer too small for the walk (ANDIX_EVENT_CAP=4) sends
    the group, as andix does, from the segmented walk to the unsegmented
    one (``chain_anchors_device``, one buffer) and then to the
    count-in-loop replay, with equal counts; the buffer is not widened."""
    from andix_torch.esa import backend

    monkeypatch.setenv("ANDIX_EVENT_CAP", "4")
    caps, replays = [], []
    orig, orig_anchors, orig_replay = (segdrive.segmented_group_anchors,
                                       backend.chain_anchors_device,
                                       backend.replay_rows)

    def counting(walk, sg, gp, qb, *rest):
        caps.append(rest[-2:])  # seg_k, ecap
        return orig(walk, sg, gp, qb, *rest)

    def unsegmented(*a):
        caps.append((1, a[11]))  # one segment, ecap
        return orig_anchors(*a)

    def replaying(*a, **kw):
        replays.append(a[6])  # exact_counts
        return orig_replay(*a, **kw)

    monkeypatch.setattr(segdrive, "segmented_group_anchors", counting)
    monkeypatch.setattr(backend, "chain_anchors_device", unsegmented)
    monkeypatch.setattr(backend, "replay_rows", replaying)
    fam = _family(3, 2000, [0.02, 0.3], seed=47)
    joint_schedule(fam, k=2)
    assert caps == [(2, 4), (1, 4)] and replays == [False]


def test_checkpoint_rows_shared_across_packages(tmp_path, monkeypatch):
    """Rows written by andix resume under andix_torch without work, and
    the other way round (same format 3 rows, same fingerprint)."""
    fam = _family(4, 1200, [0.03, 0.08, 0.2], seed=53)
    jseqs = [JSeq(d, nm) for nm, d in fam]
    seqs = [Seq(d, nm) for nm, d in fam]
    cpu = [torch.device("cpu")]
    assert (pipeline.checkpoint_fingerprint(seqs, Context())
            == jpipeline.checkpoint_fingerprint(jseqs, JContext()))

    def no_work(*a, **kw):
        raise AssertionError("a checkpointed row was recomputed")

    d1 = str(tmp_path / "from_jax")
    ref = jpipeline.calculate_matrix(jseqs, JContext(checkpoint_dir=d1))
    with monkeypatch.context() as m:
        m.setattr(pipeline, "make_blocks", no_work)
        got = pipeline.calculate_matrix(seqs, Context(checkpoint_dir=d1),
                                        cpu)
    assert (_grid(got, 4) == _grid(ref, 4)).all()

    d2 = str(tmp_path / "from_torch")
    first = pipeline.calculate_matrix(seqs, Context(checkpoint_dir=d2),
                                      cpu)
    os.remove(os.path.join(d2, "row_2.npz"))  # one row left to compute
    resumed = jpipeline.calculate_matrix(jseqs, JContext(checkpoint_dir=d2))
    assert (_grid(resumed, 4) == _grid(first, 4)).all()
    with monkeypatch.context() as m:
        m.setattr(jpipeline, "make_blocks", no_work)
        m.setattr(jpipeline, "_process_sharded", no_work)
        again = jpipeline.calculate_matrix(jseqs,
                                           JContext(checkpoint_dir=d2))
    assert (_grid(again, 4) == _grid(first, 4)).all()


def test_port_imports_neither_jax_nor_andix():
    code = (
        "import sys\n"
        "import andix_torch, andix_torch.cli, andix_torch.pipeline\n"
        "import andix_torch.kernels, andix_torch.native\n"
        "import andix_torch.parallel, andix_torch._distributed\n"
        "import andix_torch.device, andix_torch.oracle\n"
        "import andix_torch.chain.replay_device, andix_torch.esa.backend\n"
        "import andix_torch.subject_pipeline, andix_torch.chain.walk_sx\n"
        "import andix_torch.esa.subject_index, andix_torch.esa.sa_numpy\n"
        "import numpy\n"
        "andix_torch.esa.subject_index.build_subject_index_np("
        "numpy.frombuffer(b'ACGTTGCA', numpy.uint8), 2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'andix'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True)


def test_device_choice(monkeypatch):
    from andix_torch import _distributed, device

    assert device.resolve_devices("cpu") == [torch.device("cpu")]
    for name in ("jax", "numpy", "tpu"):
        with pytest.raises(device.DeviceError):
            device.resolve_devices(name)
    # every visible card; one card a process, LOCAL_RANK's, under a group
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert device.resolve_devices("cuda") == [torch.device("cuda", i)
                                              for i in range(3)]
    monkeypatch.setattr(_distributed, "world_size", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "4")
    assert device.resolve_devices("auto") == [torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "cuda"):
        with pytest.raises(device.DeviceError, match="no"):
            device.resolve_devices(name)

"""andix_torch's pair grid over several workers, on the CPU: the sharded
joint grid on 2, 3 and 8 CPU workers against andix's sharded grid (8
virtual CPU devices, tests/conftest.py) and the port's one-device run, on
the families of tests/test_multidevice.py; which path runs; checkpoint rows
across the two packages; the subject-index workers; a failing worker; the
memory split; and two processes under torch.distributed (gloo on
loopback) through the CLI."""

import inspect
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from andix import cli as jcli
from andix import parallel as jparallel
from andix import pipeline as jpipeline
from andix import subject_pipeline as jsubject_pipeline
from andix.esa.backend_jax import JaxBackend
from andix.runtime import Context as JContext, Model as JModel
from andix.sequence import Seq as JSeq
from andix_torch import cli, parallel, pipeline, subject_pipeline
from andix_torch.esa.backend import TorchBackend
from andix_torch.runtime import Context, Model
from andix_torch.sequence import Seq

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUCL = np.frombuffer(b"ACGT", dtype=np.uint8)
CPU = torch.device("cpu")


def _family(n, length, seed):
    """g0 random, g_k = g0 with substitutions at 0.02 + 0.02 (k - 1)."""
    r = np.random.default_rng(seed)
    base = NUCL[r.integers(0, 4, length)]
    out = [("g0", base)]
    for k in range(1, n):
        codes = np.searchsorted(NUCL, base)
        hit = r.random(length) < 0.02 * k
        out.append((f"g{k}", NUCL[(codes + np.where(
            hit, r.integers(1, 4, length), 0)) % 4]))
    return out


def _grid(M, n):
    return np.array([[M[i][j].counts for j in range(n)] for i in range(n)])


def _port(fam, ctx=None, devices=None):
    return pipeline.calculate_matrix([Seq(d, nm) for nm, d in fam],
                                     ctx or Context(), devices or [CPU])


# tests/test_multidevice.py's families: (genomes, length, model, env)
FAMILIES = {
    "6x600": (6, 600, "JC", {}),
    "5x500_logdet": (5, 500, "LogDet", {}),
    "19x250": (19, 250, "JC", {}),
    "3x300": (3, 300, "JC", {}),
    "6x400_chunked": (6, 400, "JC", {"ANDIX_MAX_QUERY_SYMS": "900"}),
}


@pytest.fixture(scope="module")
def sharded_refs():
    """Per family, lazily: (family, env, model, andix's sharded grid on 8
    devices, the port's one-device grid), both on the joint schedule."""
    cache = {}

    def get(name):
        if name not in cache:
            n, length, model, env = FAMILIES[name]
            env = dict(env, ANDIX_INDEX="joint")
            fam = _family(n, length, seed=len(cache) + 61)
            with pytest.MonkeyPatch.context() as mp:
                for k, v in env.items():
                    mp.setenv(k, v)
                info = jparallel._sharded_counts_fn.cache_info()
                before = info.hits + info.misses
                ref = jpipeline.calculate_matrix(
                    [JSeq(d, nm) for nm, d in fam],
                    JContext(model=JModel(model)), JaxBackend())
                info = jparallel._sharded_counts_fn.cache_info()
                assert info.hits + info.misses > before, "andix not sharded"
                one = _port(fam, Context(model=Model(model)))
            cache[name] = (fam, env, model, _grid(ref, n), _grid(one, n))
        return cache[name]

    return get


@pytest.mark.parametrize("workers", [2, 3, 8])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_grid_equals_andix_and_one_device(sharded_refs, monkeypatch,
                                                  family, workers):
    fam, env, model, ref, one = sharded_refs(family)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    orig = pipeline._process_sharded
    monkeypatch.setattr(pipeline, "_process_sharded",
                        lambda *a: calls.append(a) or orig(*a))
    got = _grid(_port(fam, Context(model=Model(model)), [CPU] * workers),
                len(fam))
    assert calls, "the sharded grid did not run"
    assert (one == ref).all()
    assert (got == ref).all()
    shares = [b for b in parallel.round_robin_blocks(len(fam), workers) if b]
    assert [ln.split(", ")[0] for ln in pipeline.LAST_BALANCE] == [
        f"worker {w} on cpu: rows {b[0]}..{b[-1]}"
        for w, b in enumerate(shares)]


def test_round_robin_blocks_is_andix_s():
    assert (inspect.getsource(parallel.round_robin_blocks)
            == inspect.getsource(jparallel.round_robin_blocks))


@pytest.mark.parametrize("case", ["sharded", "low_memory", "unsharded",
                                  "one_row"])
def test_path_taken(tmp_path, monkeypatch, case):
    """Several workers take the sharded grid; -l, ANDIX_SHARDED=0 and one
    row left to do keep the serial schedule, with the same grid."""
    monkeypatch.setenv("ANDIX_INDEX", "joint")
    fam = _family(4, 500, seed=7)
    want = _grid(_port(fam), 4)
    ctx = Context()
    if case == "low_memory":
        ctx = Context(low_memory=True)
    elif case == "unsharded":
        monkeypatch.setenv("ANDIX_SHARDED", "0")
    elif case == "one_row":
        ctx = Context(checkpoint_dir=str(tmp_path))
        _port(fam, ctx)
        os.remove(tmp_path / "row_2.npz")
    calls = {"sharded": 0, "blocks": []}
    sharded, block = pipeline._process_sharded, pipeline._process_block

    def spy_sharded(*a):
        calls["sharded"] += 1
        return sharded(*a)

    def spy_block(blk, *a, **kw):
        calls["blocks"].append(list(blk))
        return block(blk, *a, **kw)

    monkeypatch.setattr(pipeline, "_process_sharded", spy_sharded)
    monkeypatch.setattr(pipeline, "_process_block", spy_block)
    got = _grid(_port(fam, ctx, [CPU, CPU]), 4)
    assert (got == want).all()
    assert calls["sharded"] == (case == "sharded")
    if case == "sharded":
        assert sorted(calls["blocks"]) == [[0, 1], [2, 3]]
    elif case == "one_row":
        assert calls["blocks"] == [[2]]


def test_checkpoint_rows_shared_with_andix_sharded(tmp_path, monkeypatch):
    """Rows the port's sharded grid writes resume under andix without
    work; rows andix's sharded grid writes resume under the port's sharded
    grid, which recomputes only the rows removed."""
    monkeypatch.setenv("ANDIX_INDEX", "joint")
    fam = _family(5, 500, seed=9)
    jseqs = [JSeq(d, nm) for nm, d in fam]

    def no_work(*a, **kw):
        raise AssertionError("a checkpointed row was recomputed")

    d1 = str(tmp_path / "from_torch")
    first = _port(fam, Context(checkpoint_dir=d1), [CPU] * 3)
    assert sorted(os.listdir(d1)) == [f"row_{i}.npz" for i in range(5)]
    with monkeypatch.context() as m:
        m.setattr(jpipeline, "make_blocks", no_work)
        m.setattr(jpipeline, "_process_sharded", no_work)
        again = jpipeline.calculate_matrix(jseqs, JContext(checkpoint_dir=d1),
                                           JaxBackend())
    assert (_grid(again, 5) == _grid(first, 5)).all()

    d2 = str(tmp_path / "from_jax")
    ref = jpipeline.calculate_matrix(jseqs, JContext(checkpoint_dir=d2),
                                     JaxBackend())
    for i in (1, 3):
        os.remove(os.path.join(d2, f"row_{i}.npz"))
    blocks = []
    block = pipeline._process_block
    monkeypatch.setattr(pipeline, "_process_block",
                        lambda blk, *a, **kw: blocks.append(list(blk))
                        or block(blk, *a, **kw))
    got = _port(fam, Context(checkpoint_dir=d2), [CPU, CPU])
    assert sorted(blocks) == [[1], [3]]
    assert (_grid(got, 5) == _grid(ref, 5)).all()


@pytest.fixture(scope="module")
def subject_refs():
    """Per ANDIX_GROUP_SUBJECTS, lazily: (family, andix's threaded subject
    schedule on 8 devices, the port's serial subject schedule)."""
    cache = {}
    fam = _family(5, 1200, seed=13)

    def get(group):
        if group not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("ANDIX_INDEX", "subject")
                mp.setenv("ANDIX_GROUP_SUBJECTS", str(group))
                ref = jpipeline.calculate_matrix(
                    [JSeq(d, nm) for nm, d in fam], JContext(), JaxBackend())
                assert len(jsubject_pipeline.LAST_BALANCE) == -(-5 // group)
                serial = _port(fam)
            cache[group] = (fam, _grid(ref, 5), _grid(serial, 5))
        return cache[group]

    return get


@pytest.mark.parametrize("workers", [2, 3])
@pytest.mark.parametrize("group", [1, 2])
def test_subject_workers_equal_serial_and_andix(subject_refs, monkeypatch,
                                                group, workers):
    fam, ref, serial = subject_refs(group)
    monkeypatch.setenv("ANDIX_INDEX", "subject")
    monkeypatch.setenv("ANDIX_GROUP_SUBJECTS", str(group))
    got = _grid(_port(fam, devices=[CPU] * workers), 5)
    assert (serial == ref).all()
    assert (got == ref).all()
    groups = -(-5 // group)
    lines = subject_pipeline.LAST_BALANCE
    assert len(lines) == groups + workers
    for w in range(workers):
        mine = [ln for ln in lines if ln.startswith(f"worker {w} on cpu")]
        # its round-robin groups, each with its events, then its wall
        assert len(mine) == len(range(w, groups, workers)) + 1
        assert mine[-1].startswith(f"worker {w} on cpu: wall ")


def test_sx_mesh_off_keeps_one_worker(monkeypatch):
    monkeypatch.setenv("ANDIX_INDEX", "subject")
    monkeypatch.setenv("ANDIX_GROUP_SUBJECTS", "1")
    monkeypatch.setenv("ANDIX_SX_MESH", "0")
    _port(_family(3, 1200, seed=3), devices=[CPU] * 3)
    assert all(ln.startswith("worker 0 on cpu")
               for ln in subject_pipeline.LAST_BALANCE)


@pytest.mark.parametrize("schedule", ["joint", "subject"])
def test_failing_worker_fails_the_run(monkeypatch, schedule):
    """One worker's kernel wrapper raises: the other workers finish, and
    calculate_matrix raises instead of returning a grid with holes."""
    from andix_torch.esa import backend

    from andix_torch.chain import replay_device

    monkeypatch.setenv("ANDIX_INDEX", schedule)
    monkeypatch.setenv("ANDIX_GROUP_SUBJECTS", "1")
    # the joint walk's wrapper, as the segmented driver (backend) and the
    # unsegmented walk (replay_device.chain_anchors_device) reach it
    targets = ([(backend, "chain_walk_flat"),
                (replay_device, "chain_walk_flat")] if schedule == "joint"
               else [(subject_pipeline, "chain_walk_flat_sx")])
    orig = getattr(*targets[0])
    lock = threading.Lock()
    calls = []

    def first_raises(*a, **kw):
        with lock:
            calls.append(threading.current_thread())
            if len(calls) == 1:
                raise RuntimeError("injected launch failure")
        return orig(*a, **kw)

    for module, name in targets:
        monkeypatch.setattr(module, name, first_raises)
    with pytest.raises(RuntimeError, match="injected launch failure"):
        _port(_family(4, 800, seed=17), devices=[CPU, CPU])
    assert len(set(calls)) == 2  # the other worker ran on


def test_run_workers_joins_before_raising():
    done = []

    def fails(msg):
        raise ValueError(msg)

    def slow():
        time.sleep(0.3)
        done.append(True)

    with pytest.raises(ValueError, match="first") as info:
        parallel.run_workers([lambda: fails("first"), slow,
                              lambda: fails("second")])
    assert done == [True]
    assert "1 other worker(s) failed" in str(info.value.__cause__)
    assert "second" in str(info.value.__cause__)
    assert len(parallel.run_workers([slow, slow])) == 2


def test_run_workers_gives_each_job_a_thread():
    """Jobs run on threads of their own even when one ends at once."""
    threads = []
    parallel.run_workers([lambda: threads.append(threading.current_thread())
                          for _ in range(4)])
    assert len(set(threads)) == 4


def test_shared_counters_lose_no_update():
    """More worker threads than cores bump the launch counts and a
    progress meter with a tiny switch interval: no update is lost."""
    from andix_torch import kernels

    class Meter:
        count = 0

        def advance(self, k):
            count = self.count
            time.sleep(0)  # a thread switch between the read and the write
            self.count = count + k

    meter = parallel.LockedProgress(Meter())
    cards = [torch.device("cuda", k) for k in range(3)]
    old = sys.getswitchinterval()
    kernels.reset_launches()
    try:
        sys.setswitchinterval(1e-6)

        def bump(w):
            for _ in range(500):
                kernels.count_launch("flag_scan", cards[w % 3])
                meter.advance(1)

        parallel.run_workers([lambda w=w: bump(w) for w in range(16)])
        assert kernels.launches["flag_scan"] == 8000
        assert sum(c["flag_scan"] for c in kernels.launches_by_card.values()
                   ) == 8000
        assert kernels.launches_by_card[1]["flag_scan"] == 5 * 500
        assert meter.meter.count == 8000
    finally:
        sys.setswitchinterval(old)
        kernels.reset_launches()


@pytest.mark.parametrize("schedule", ["joint", "subject"])
def test_workers_on_one_device_split_its_memory(monkeypatch, schedule):
    """Two workers on one device each plan with half its budget."""
    monkeypatch.setenv("ANDIX_INDEX", schedule)
    monkeypatch.setenv("ANDIX_GROUP_SUBJECTS", "2")
    full = pipeline.memory_budget(CPU)
    assert pipeline.memory_budget(CPU, 2) == full // 2
    seen = {"plan": [], "groups": [], "shares": [], "budgets": []}
    plan, groups = pipeline.device_plan, subject_pipeline.plan_groups
    monkeypatch.setattr(pipeline, "device_plan", lambda b, s, budget: (
        seen["plan"].append(budget) or plan(b, s, budget)))
    monkeypatch.setattr(subject_pipeline, "plan_groups",
                        lambda s, t, lm, k, budget, fixed: (
                            seen["groups"].append(budget)
                            or groups(s, t, lm, k, budget, fixed)))
    init = TorchBackend.__init__

    def spy_init(self, device, threads=0, share=1, budget=None):
        seen["shares"].append(share)
        seen["budgets"].append(budget)
        init(self, device, threads, share, budget)

    monkeypatch.setattr(TorchBackend, "__init__", spy_init)
    fam = _family(4, 600, seed=19)
    _port(fam, devices=[CPU])
    _port(fam, devices=[CPU, CPU])
    assert seen["plan"] == [full, full // 2]
    if schedule == "subject":
        assert seen["groups"] == [full, full // 2]
    else:
        # the one-worker run's backend, then each sharded worker's; each
        # takes its budget from the plan, not from the device again
        assert seen["shares"] == [1, 2, 2]
        assert seen["budgets"] == [full, full // 2, full // 2]


@pytest.mark.parametrize("local_world, count, device, workers, share", [
    (None, 1, CPU, 1, 2),    # WORLD_SIZE=2, no LOCAL_WORLD_SIZE: one host
    ("2", 1, CPU, 2, 4),     # two ranks, each with two workers
    ("2", 1, torch.device("cuda", 0), 1, 2),  # both ranks on one card
    ("2", 2, torch.device("cuda", 1), 1, 1),  # a card a rank
    ("4", 2, torch.device("cuda", 1), 1, 2),  # local ranks 1 and 3
    ("3", 2, torch.device("cuda", 0), 2, 4),  # local ranks 0 and 2
])
def test_ranks_on_one_device_split_its_memory(monkeypatch, local_world,
                                              count, device, workers, share):
    """Under a process group of two ranks the ranks of this host that take
    a device split its memory too, times the rank's own workers there."""
    from andix_torch import _distributed, device as device_mod

    monkeypatch.setattr(_distributed, "world_size", lambda: 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    monkeypatch.setattr(pipeline, "memory_budget", lambda d, s=1: 1200 // s)
    assert device_mod.ranks_on(device) == share // workers
    shares, budget = pipeline.worker_memory([device] * workers)
    assert shares == [share] * workers
    assert budget == 1200 // share
    monkeypatch.setattr(_distributed, "world_size", lambda: 1)
    assert pipeline.worker_memory([device] * workers) == (
        [workers] * workers, 1200 // workers)


# --- two processes -------------------------------------------------------

def _write_family(tmp_path, fam):
    paths = []
    for name, data in fam:
        p = tmp_path / f"{name}.fa"
        p.write_text(f">{name}\n{data.tobytes().decode()}\n")
        paths.append(str(p))
    return paths


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# the CLI with every joint block failing, as a rank whose worker raises
_FAILING_CLI = (
    "import sys\n"
    "from andix_torch import cli, pipeline\n"
    "def fail(*a, **kw):\n"
    "    raise RuntimeError('injected worker failure')\n"
    "pipeline._process_block = fail\n"
    "sys.exit(cli.main(sys.argv[1:]))\n"
)


def _two_processes(args, tmp_path, env=None, failing_rank=None):
    """``python -m andix_torch.cli args`` as ranks 0 and 1 of a gloo group
    on loopback (torchrun's variables), ``failing_rank`` running the CLI
    with a joint block that raises; [(returncode, stdout, stderr)]."""
    port = _free_port()
    procs = []
    for rank in range(2):
        penv = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        penv.update(env or {}, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                    RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        if "ANDIX_PROF_FILE" in penv:
            penv["ANDIX_PROF_FILE"] += f".{rank}"
        entry = (["-c", _FAILING_CLI] if rank == failing_rank
                 else ["-m", "andix_torch.cli"])
        procs.append(subprocess.Popen(
            [sys.executable] + entry + args, env=penv,
            cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=240)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_two_processes(tmp_path, capsys):
    """Rank 0 prints andix-torch's and andix's bytes, rank 1 nothing; a
    checkpoint resume under two processes recomputes nothing."""
    paths = _write_family(tmp_path, _family(5, 3000, seed=23))
    args = ["--progress=never"] + paths
    assert cli.main(["--backend", "cpu"] + args) == 0
    single = capsys.readouterr().out
    assert jcli.main(["--backend", "numpy"] + args) == 0
    assert capsys.readouterr().out == single

    ck = tmp_path / "ck"
    run = ["--backend", "cpu", "--checkpoint", str(ck)] + args
    res = _two_processes(run, tmp_path)
    for rank, (code, _, err) in enumerate(res):
        assert code == 0, f"rank {rank}: {err[-3000:]}"
    assert res[0][1] == single
    assert res[1][1] == ""
    assert sorted(os.listdir(ck)) == [f"row_{i}.npz" for i in range(5)]

    prof = tmp_path / "prof"
    again = _two_processes(run, tmp_path, {"ANDIX_PROF_FILE": str(prof)})
    assert [(c, o) for c, o, _ in again] == [(0, single), (0, "")]
    assert not any(os.path.exists(f"{prof}.{r}") for r in range(2)), (
        "a resumed run did device work")


@pytest.mark.parametrize("failing_rank", [0, 1])
def test_two_processes_a_failing_rank_fails_both(tmp_path, failing_rank):
    """A rank whose worker raises exits non-zero, and the other rank's
    collective fails on the closed connection at once, not after gloo's
    timeout: both exit non-zero and nothing is printed."""
    paths = _write_family(tmp_path, _family(5, 3000, seed=23))
    t0 = time.time()
    res = _two_processes(["--backend", "cpu", "--progress=never"] + paths,
                         tmp_path, failing_rank=failing_rank)
    assert time.time() - t0 < 200
    assert [code != 0 for code, _, _ in res] == [True, True], res
    assert [out for _, out, _ in res] == ["", ""]
    assert "injected worker failure" in res[failing_rank][2]


# two ranks gather one row each; rank 1 reaches the gather 3 s late.  Both
# ranks start joining the group together (each waits for the other's
# "ready" file), so the join never waits long, and each prints "joined"
# once it is in the group.
_LATE_GATHER = (
    "import os, sys, time\n"
    "import numpy as np\n"
    "from andix_torch import _distributed, parallel\n"
    "from andix_torch.model import CountMatrix\n"
    "_distributed.COLLECTIVE_TIMEOUT_S = int(sys.argv[1])\n"
    "rank = int(os.environ['RANK'])\n"
    "open(f'ready{rank}', 'w').close()\n"
    "while not os.path.exists(f'ready{1 - rank}'):\n"
    "    time.sleep(0.01)\n"
    "_distributed.maybe_init_distributed()\n"
    "print('joined', flush=True)\n"
    "if rank == 1:\n"
    "    time.sleep(3)\n"
    "row = {1 - rank: CountMatrix(np.full(16, rank, np.int64), 7)}\n"
    "got = parallel.gather_rows({rank: row}, 2)\n"
    "print(sorted(got) if got is not None else '')\n"
    "_distributed.shutdown()\n"
)


def _late_gather(tmp_path, timeout_s):
    port = _free_port()
    procs = []
    for rank in range(2):
        penv = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        penv.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", RANK=str(rank),
                    LOCAL_RANK=str(rank), WORLD_SIZE="2",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _LATE_GATHER, str(timeout_s)], env=penv,
            cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=120)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("timeout_s,late_rank_fits", [(2, False),
                                                      (10, True)])
def test_collective_timeout_governs_the_gather(tmp_path, timeout_s,
                                               late_rank_fits):
    """Rank 0 waits in ``gather_rows`` for rank 1, which comes 3 s late:
    with the timeout constant at 2 s the gather fails after both ranks
    joined the group, at 10 s it completes and rank 0 holds both rows."""
    res = _late_gather(tmp_path, timeout_s)
    if late_rank_fits:
        assert [(c, o) for c, o, _ in res] == [(0, "joined\n[0, 1]\n"),
                                               (0, "joined\n\n")], res
    else:
        assert res[0][0] != 0 and res[0][1] == "joined\n", res
        assert res[1][1].startswith("joined\n"), res
        assert "timed out" in res[0][2].lower() or "timeout" in res[0][2].lower()


def test_collective_timeout_is_hour_scale():
    """The default outlasts a day-long run's gap between ranks."""
    from andix_torch import _distributed

    assert _distributed.COLLECTIVE_TIMEOUT_S >= 86_400

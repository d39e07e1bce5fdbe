"""Each metric reader on a recorded phase file and canned profiler
events, with the values worked out by hand."""

import types

import pytest
import torch
import portbench_tiny  # noqa: F401  (the root on the path)

from portbench import phases, trace
from portbench.run import HBM_BYTES_PER_S, load_metric, ROOT

JOINT = """\
[cuda:0] H2D text (100663296 padded symbols): 0.509438s
[cuda:0] SA doubling (8 levels, buffer 8): 0.068107s
[cuda:0] LCP hybrid: 0.005085s
[cuda:0] block tables (segid+isa+tq+rmq): 0.035095s
[cuda:0] subject tables (8 subj): 0.121849s
[cuda:0] segmented walk: 5 dispatches, 196584 probe steps, 3927040 events: 0.544226s
[cuda:0] host count from 3927040 events: 0.343195s
"""
SUBJECT = """\
[cuda:0] sx: query words H2D: 0.053431s
[cuda:0] sx: index build (8 subj, 0 host LCP round trips after a level overflow): 0.592291s
[cuda:0] sx: segmented walk: 6 dispatches, 3000 probe steps, 3900000 events: 1.576070s
[cuda:0] sx: host count from 3900000 events: 0.372368s
"""


def record(text, walls):
    return {"phase_matrices": [{"wall_s": w, "phases": phases.parse(text)}
                               for w in walls],
            "hbm_bytes_per_s": HBM_BYTES_PER_S}


def ev(name, start, end, device=True, card=0):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU),
        device_index=card if device else -1)


def canned_profile():
    """Two marked matrices of 1000 us each; device intervals overlap and
    leave gaps; the host samples name what ran in them."""
    events = [
        ev(trace.MARK, 0, 1000, device=False),
        ev(trace.MARK, 2000, 3000, device=False),
        ev("void flag_scan_kernel<false>(FsArgs)", 100, 300),
        ev("void flag_scan_kernel<true>(FsArgs)", 250, 400),  # overlaps
        ev("initial_key_kernel(int const*)", 2100, 2200),
        ev("void cub::CUB_200200_900_NS::DeviceRadixSortOnesweepKernel<x>",
           2200, 2400),
        ev("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<y>",
           2500, 2600),
        ev("Memcpy HtoD (Pageable -> Device)", 2900, 3100),  # past the span
        ev("outside", 5000, 6000),
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    # the host clock runs 10,000 us ahead of the profiler's
    samples = [(10_050.0, "fasta.py:read_fasta"),
               (10_700.0, "chain/segmented.py:segmented_group_anchors"),
               (12_050.0, "cli.py:main"), (12_450.0, "chain/events.py:count"),
               (12_800.0, "output.py:print_distances")]
    return trace.read_profile(prof, [10_000.0, 12_000.0], samples)


def test_read_profile_busy_gaps_and_labels():
    p = canned_profile()
    assert p["matrices"] == 2 and p["wall_s"] == pytest.approx(2000e-6)
    # matrix 1 busy 100-400 (300 us); matrix 2 2100-2400, 2500-2600,
    # 2900-3000 (500 us)
    assert p["busy_s"] == pytest.approx(800e-6)
    idle = p["idle_by_host"]
    assert idle["fasta.py:read_fasta"] == pytest.approx(100e-6)
    assert idle["chain/segmented.py:segmented_group_anchors"] == \
        pytest.approx(600e-6)
    assert idle["cli.py:main"] == pytest.approx(100e-6)
    assert idle["chain/events.py:count"] == pytest.approx(100e-6)
    assert idle["output.py:print_distances"] == pytest.approx(300e-6)
    assert p["kernels"]["void flag_scan_kernel<false>(FsArgs)"] == \
        pytest.approx((200e-6, 1))


def test_read_profile_busy_by_card():
    """Two cards' overlapping intervals: each card its own union, and
    ``busy_s`` the union over both; a visible card with none reads 0."""
    events = [
        ev(trace.MARK, 0, 1000, device=False),
        ev("walk", 100, 500, card=0),
        ev("sort", 400, 600, card=0),  # overlaps card 0's walk
        ev("walk", 300, 900, card=1),  # overlaps both on card 0
        ev("copy", 950, 1200, card=1),  # past the span
    ]
    p = trace.read_profile(types.SimpleNamespace(events=lambda: events),
                           [0.0], [], cards=3)
    assert p["busy_s_by_card"] == pytest.approx(
        {0: 500e-6, 1: 650e-6, 2: 0.0})
    assert p["busy_s"] == pytest.approx(850e-6)


def test_one_card_busy_by_card_is_the_union():
    p = canned_profile()
    assert p["busy_s_by_card"] == {0: p["busy_s"]}


def test_peak_is_the_fullest_cards():
    from portbench.run import card_peaks

    one = card_peaks([3 * 2**30 + 12345])
    assert one["peak_bytes"] == one["peak_bytes_by_card"][0]
    assert metric("peak_device_GiB")(one) == (3 * 2**30 + 12345) / 2**30
    four = card_peaks([2**30, 5 * 2**30, 0, 2**31])
    assert four["peak_bytes"] == 5 * 2**30
    assert metric("peak_device_GiB")(four) == pytest.approx(5.0)
    assert card_peaks([]) == {"peak_bytes_by_card": [], "peak_bytes": 0}


def metric(name):
    return load_metric(ROOT, name)


def test_phase_readers_on_a_recorded_joint_matrix():
    rec = record(JOINT, [2.5, 2.7])
    total = 0.509438 + 0.068107 + 0.005085 + 0.035095 + 0.121849 \
        + 0.544226 + 0.343195
    assert metric("host_shell_s")(rec) == pytest.approx(2.6 - total)
    assert metric("joint.upload_s")(rec) == pytest.approx(0.509438)
    assert metric("joint.build_s")(rec) == pytest.approx(
        0.068107 + 0.005085 + 0.035095 + 0.121849)
    assert metric("joint.walk_s")(rec) == pytest.approx(0.544226)
    assert metric("count_s")(rec) == pytest.approx(0.343195)
    assert metric("sx.index_s")(rec) is None
    assert metric("sx.walk_s")(rec) is None


def test_phase_readers_on_a_recorded_subject_matrix():
    rec = record(SUBJECT, [3.4])
    assert metric("sx.index_s")(rec) == pytest.approx(0.053431 + 0.592291)
    assert metric("sx.walk_s")(rec) == pytest.approx(1.576070)
    assert metric("count_s")(rec) == pytest.approx(0.372368)
    assert metric("joint.upload_s")(rec) is None
    assert metric("joint.walk_s")(rec) is None


def test_device_readers_on_canned_events():
    rec = record(JOINT, [2.5])
    rec["profile"] = canned_profile()
    assert metric("device_idle_pct")(rec) == pytest.approx(60.0)
    # two flag scan launches, 350 us in all, over two matrices
    want = 25 * 100663296 * 1 / HBM_BYTES_PER_S / 175e-6 * 100
    assert metric("flag_scan_roofline")(rec) == pytest.approx(want)
    # the loop: the key kernel and the toolkit's sort, not torch's
    want = (8 + 4 * 8) * 100663296 / HBM_BYTES_PER_S / 150e-6 * 100
    assert metric("sa_loop_roofline")(rec) == pytest.approx(want)


def test_device_readers_find_nothing_without_a_trace():
    rec = record(JOINT, [2.5])
    for name in ("device_idle_pct", "flag_scan_roofline", "sa_loop_roofline"):
        assert metric(name)(rec) is None


def test_end_to_end_readers():
    rec = {"window": {"seconds": 31.0, "completed": 10},
           "cold_matrix_s": 3.1, "setup_s": 17.5, "peak_bytes": 3 * 2**30}
    assert metric("matrix_s")(rec) == pytest.approx(3.1)
    assert metric("cold_matrix_s")(rec) == 3.1
    assert metric("setup_s")(rec) == 17.5
    assert metric("peak_device_GiB")(rec) == pytest.approx(3.0)
    assert metric("peak_device_GiB")({"peak_bytes": 0}) is None

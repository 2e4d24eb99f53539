"""The harness's arithmetic on fixed inputs: the union of device
intervals, idle gaps, the roofline bounds and the operation counts."""
import pytest

from portbench.harness.trace import Tracer, gaps, label_gap, union_busy
from portbench.roofline import dp_clip, peaks, ser_cnn


def test_union_of_intervals():
    assert union_busy([]) == 0
    assert union_busy([(0, 10), (5, 15), (20, 30)]) == 25
    assert union_busy([(20, 30), (0, 10), (2, 3)]) == 20
    assert union_busy([(0, 10), (10, 12)]) == 12


def test_gaps_and_labels():
    assert gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [(0, 2), (6, 8),
                                                     (9, 10)]
    assert gaps([(0, 10)], 0, 10) == []
    phases = [("outer", 0, 100), ("inner", 5, 9)]
    assert label_gap((6, 8), phases) == "inner"
    assert label_gap((50, 60), phases) == "outer"
    assert label_gap((200, 210), phases) == "host: unmarked"


def test_tracer_reductions_on_a_fixed_trace():
    t = Tracer(on=False, device="cpu")
    t.t0_ns, t.t1_ns, t.offset_ns = 0, 1_000_000_000, 0
    t.trace_end_ns = t.t1_ns
    t.kernels = [("a", 0, 200_000_000), ("b", 100_000_000, 300_000_000),
                 ("a", 500_000_000, 600_000_000)]
    t.phases = [("submit_cohort", 300_000_000, 500_000_000)]
    assert t.busy_s() == pytest.approx(0.4)
    assert t.kernel_seconds(lambda n: n == "a") == pytest.approx(0.3)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["a", pytest.approx(0.3)]
    assert bd["idle_gaps"][0] == ["host: unmarked", pytest.approx(0.4)]
    assert bd["idle_gaps"][1] == ["submit_cohort", pytest.approx(0.2)]


def test_dp_clip_bytes_match_the_kernel_table():
    # PERF.md's kernel table: the norms pass at K = 4, B = 128,
    # D = 317,124 is bound by 0.1939 ms, the clipped mean with noise by
    # 0.1969 ms
    nbytes, flops = dp_clip.sqnorm(4 * 128, 317124)
    assert peaks.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.1939,
                                                               abs=5e-5)
    nbytes, flops = dp_clip.scale_mean(4, 128, 317124, noise=True)
    assert peaks.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.1969,
                                                               abs=5e-5)


SER = {"time_frames": 64, "n_mels": 40, "channels1": 64, "channels2": 128,
       "kernel": 5, "gn_groups": 8, "fc_dim": 128, "num_classes": 4}


def test_ser_cnn_counts():
    assert ser_cnn.param_count(SER) == 317124
    assert ser_cnn.forward_flops(SER) == 2 * (64 * 40 * 64 * 5
                                              + 32 * 64 * 128 * 5
                                              + 16 * 128 * 128 + 128 * 4)
    nbytes, flops = ser_cnn.member_step(SER, 128)
    # bytes bound it: ~0.097 ms a member step
    assert peaks.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.0969,
                                                               abs=1e-4)


def test_rates_are_all_work_over_all_time():
    from portbench.harness.runner import Work
    w = Work("x", units=300, attempted=3, failed=0)
    assert w.units / 1.5 == 200


def test_tracer_counts_units_and_ends_past_its_seconds():
    t = Tracer(on=False, device="cpu", seconds=0.0)
    t.start()
    t.tick()
    t.tick()
    t.stop()
    assert t.units == 2 and t.traced_units is None    # no profiler: no trace
    assert t.window_s > 0

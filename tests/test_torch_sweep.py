"""The port's sweep runner and its metrics helpers against the JAX
package's: ``SweepCell`` / ``run_cell`` / ``sweep`` (event cells in a
``spawn`` pool and in this process, fluid cells on the CPU), the event
branch of ``sweep_ci``, ``summarize``, ``replay_summary``, the CSV rows,
``describe`` and ``trace.is_large`` / ``is_long``.

Event records are ``==`` the reference's, ``wall_s`` (a wall clock)
aside; fluid records agree within 1e-6 relative with the finished counts
exact (the fluid step's float32 drains, as the fluid parity tests hold
them).
"""

import dataclasses
import math

import pytest

import repro.core.trace as rtrace
import repro.scenarios as R
import repro_torch.core.trace as ptrace
import repro_torch.scenarios as P
from repro.scenarios.metrics import replay_summary as r_replay_summary
from repro_torch.scenarios.metrics import CI_CSV_FIELDS, CSV_FIELDS
from repro_torch.scenarios.metrics import replay_summary as p_replay_summary

SIDES = {"port": P, "ref": R}
EVENT_NAMES = ["paper", "oversub_fabric"]
EVENT_COMMS = ("ada", "srsf1", "srsf2")


def _eq(a, b):
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


def assert_same_record(got, ref, rel=0.0):
    """Every field of the reference's record (the port's adds ``chunks``),
    ``wall_s`` aside; floats within ``rel`` when it is given."""
    for f in dataclasses.fields(ref):
        if f.name == "wall_s":
            continue
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if rel and isinstance(b, float) and not math.isnan(b):
            assert a == pytest.approx(b, rel=rel), f.name
        else:
            assert _eq(a, b), (f.name, a, b)


def cell(side, **kw):
    mod = SIDES[side]
    return mod.SweepCell(**kw)


class TestRunCell:
    @pytest.mark.parametrize("sim_kw", [
        (),
        (("sched", "preemptive_srsf"),),
        (("comm_chunks", 2),),
        (("contention_domain", "link"), ("gating", "rescan")),
    ])
    @pytest.mark.parametrize("name", ["contended_residue", "preemption_gain"])
    def test_event_cell(self, name, sim_kw):
        kw = dict(scenario=name, seed=2, placement="lwf", kappa=1, comm="ada",
                  backend="event", overrides=tuple(sorted(R.QUICK_OVERRIDES[name].items())),
                  sim_kw=sim_kw)
        got, ref = P.run_cell(cell("port", **kw)), R.run_cell(cell("ref", **kw))
        assert got.backend == "event" and got.n_finished == got.n_jobs
        assert_same_record(got, ref)
        assert got.wall_s > 0

    @pytest.mark.parametrize("comm, placement", [("ada", "lwf"), ("srsf2", "ls"),
                                                 ("kway2", "ff")])
    def test_fluid_cell_on_the_cpu(self, comm, placement):
        kw = dict(scenario="smoke", seed=1, placement=placement, kappa=1, comm=comm,
                  backend="fluid")
        got = P.run_cell(cell("port", device="cpu", **kw))
        ref = R.run_cell(cell("ref", **kw))
        assert got.n_finished == ref.n_finished == got.n_jobs
        assert got.placement == ref.placement and got.chunks > 0
        assert_same_record(got, ref, rel=1e-6)
        direct = P.run_scenario_fluid(P.get_scenario("smoke", seed=1), comm=comm,
                                      placement=placement, device="cpu")
        assert got.avg_jct == sum(float(j) for j in direct["jct"]) / got.n_finished

    def test_fluid_cell_defaults_to_cuda(self):
        """A fluid cell without a device asks for CUDA, which this host
        lacks: it raises rather than fall back to the CPU."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        with pytest.raises(RuntimeError):
            P.run_cell(cell("port", scenario="smoke", seed=0, placement="lwf", kappa=1,
                            comm="ada", backend="fluid"))

    def test_bad_cells_raise(self):
        with pytest.raises(ValueError, match="event-backend only"):
            P.run_cell(cell("port", scenario="smoke", seed=0, placement="lwf", kappa=1,
                            comm="ada", backend="fluid", sim_kw=(("sched", "static"),),
                            device="cpu"))
        with pytest.raises(ValueError, match="unknown backend"):
            P.run_cell(cell("port", scenario="smoke", seed=0, placement="lwf", kappa=1,
                            comm="ada", backend="tpu"))

    def test_cell_fields(self):
        """The reference's fields in its order, then the port's device."""
        names = [f.name for f in dataclasses.fields(P.SweepCell)]
        assert names == [f.name for f in dataclasses.fields(R.SweepCell)] + ["device"]


class TestSweep:
    def test_event_pool_equals_serial_and_reference(self):
        kw = dict(comms=EVENT_COMMS, per_scenario_overrides=P.QUICK_OVERRIDES)
        pooled = P.sweep(EVENT_NAMES, processes=2, **kw)
        serial = P.sweep(EVENT_NAMES, **kw)
        ref = R.sweep(EVENT_NAMES, comms=EVENT_COMMS, per_scenario_overrides=R.QUICK_OVERRIDES)
        assert len(pooled) == len(serial) == len(ref) == len(EVENT_NAMES) * len(EVENT_COMMS)
        for p, s, r in zip(pooled, serial, ref):
            assert_same_record(p, s)
            assert p.chunks == s.chunks == 0
            assert_same_record(p, r)

    def test_event_matrix_with_sim_kw_and_seeds(self):
        kw = dict(comms=("ada", "kway2"), placements=("lwf", "ls"), seeds=(0, 3),
                  overrides={"n_jobs": 12}, sim_kw={"sched": "preemptive_srsf"})
        got, ref = P.sweep(["contended_residue"], **kw), R.sweep(["contended_residue"], **kw)
        assert len(got) == 8
        for g, r in zip(got, ref):
            assert (g.placement, g.comm, g.seed, g.sched) == (r.placement, r.comm, r.seed,
                                                              r.sched)
            assert_same_record(g, r)

    def test_fluid_sweep_on_the_cpu(self):
        kw = dict(comms=("ada", "srsf2"), placements=("lwf_rack", "rack_pack", "ff"),
                  seeds=(0, 1), backend="fluid")
        got = P.sweep(["smoke"], device="cpu", **kw)
        ref = R.sweep(["smoke"], **kw)
        # lwf_rack and rack_pack map to one gang mode: deduped, as the
        # reference does
        assert len(got) == len(ref) == 8
        for g, r in zip(got, ref):
            assert g.n_finished == r.n_finished
            assert_same_record(g, r, rel=1e-6)

    def test_event_sweep_ci_equals_reference(self):
        kw = dict(comms=("ada", "srsf2"), seeds=(0, 1), backend="event",
                  per_scenario_overrides={"smoke": {}, "contended_residue": {"n_jobs": 10}})
        got = P.sweep_ci(["smoke", "contended_residue"], **kw)
        ref = R.sweep_ci(["smoke", "contended_residue"], **kw)
        assert len(got) == len(ref) == 4
        for g, r in zip(got, ref):
            for f in dataclasses.fields(r):
                if f.name != "wall_s":
                    assert _eq(getattr(g, f.name), getattr(r, f.name)), f.name
        with pytest.raises(ValueError, match="event-backend only"):
            P.sweep_ci(["smoke"], seeds=(0,), sim_kw={"sched": "static"}, device="cpu")


class TestMetricsHelpers:
    def _records(self, side):
        mod = SIDES[side]
        return mod.sweep(["smoke", "contended_residue"], comms=("ada", "srsf1"), seeds=(0, 1))

    def test_summarize_equals_reference(self):
        got, ref = P.summarize(self._records("port")), R.summarize(self._records("ref"))
        assert list(got) == list(ref)
        assert got == ref

    def test_csv_rows_equal_reference(self):
        from repro.scenarios.metrics import CI_CSV_FIELDS as R_CI, CSV_FIELDS as R_CSV

        assert CSV_FIELDS == R_CSV and CI_CSV_FIELDS == R_CI
        got, ref = self._records("port"), self._records("ref")
        assert P.RunMetrics.csv_header() == R.RunMetrics.csv_header()
        for g, r in zip(got, ref):
            gv, rv = g.as_csv_row().split(","), r.as_csv_row().split(",")
            wall = CSV_FIELDS.index("wall_s")
            assert gv[:wall] + gv[wall + 1:] == rv[:wall] + rv[wall + 1:]
        cg, cr = P.ci_from_runs(got), R.ci_from_runs(ref)
        assert P.CellCI.csv_header() == R.CellCI.csv_header()
        for g, r in zip(cg, cr):
            assert g.as_csv_row().split(",")[:-1] == r.as_csv_row().split(",")[:-1]

    def test_fluid_record_csv(self):
        rec = P.run_cell(cell("port", scenario="smoke", seed=0, placement="lwf", kappa=1,
                              comm="ada", backend="fluid", device="cpu"))
        row = rec.as_csv_row().split(",")
        assert len(row) == len(CSV_FIELDS)
        assert row[CSV_FIELDS.index("gpu_util")] == "nan"
        assert row[CSV_FIELDS.index("stretch_frac")] == "nan"

    @pytest.mark.parametrize("name", ["trace_replay_synth", "trace_replay_philly",
                                      "trace_replay_alibaba"])
    def test_replay_summary_equals_reference(self, name):
        got = P.run_scenario_event(P.get_scenario(name, seed=0), comm="ada")
        ref = R.run_scenario_event(R.get_scenario(name, seed=0), comm="ada")
        window = ref.makespan / 12
        g, r = p_replay_summary(got, window), r_replay_summary(ref, window)
        assert list(g) == list(r)
        assert all(_eq(g[k], r[k]) for k in r)
        assert not any(k.startswith("phase_") for k in g)

    def test_replay_summary_phase_keys(self):
        got = P.run_scenario_event(P.get_scenario("trace_replay_philly", seed=0), comm="ada",
                                   profile_phases=True)
        ref = R.run_scenario_event(R.get_scenario("trace_replay_philly", seed=0), comm="ada",
                                   profile_phases=True)
        assert list(got.phase_seconds) == list(ref.phase_seconds) == [
            "comm_advance", "dispatch", "gating", "gpu_schedule"]
        assert all(v >= 0.0 for v in got.phase_seconds.values())
        window = ref.makespan / 8
        g, r = p_replay_summary(got, window), r_replay_summary(ref, window)
        assert list(g) == list(r)
        assert all(_eq(g[k], r[k]) for k in r if not k.startswith("phase_"))
        plain = P.run_scenario_event(P.get_scenario("trace_replay_philly", seed=0), comm="ada")
        assert plain.phase_seconds is None
        for f in dataclasses.fields(plain):
            if f.name != "phase_seconds":
                assert getattr(got, f.name) == getattr(plain, f.name), f.name


class TestRegistryAndTrace:
    def test_describe_every_scenario(self):
        names = P.scenario_names()
        assert len(names) == 20 and names == R.scenario_names()
        for name in names:
            assert P.describe(name) == R.describe(name) != "", name
        assert P.describe("no_such_scenario") == ""

    def test_register_description(self):
        from repro_torch.scenarios import registry

        @registry.register("_described_in_test", "a one-line description")
        def _a(seed=0):
            return None

        @registry.register("_docstring_in_test")
        def _b(seed=0):
            """Its docstring."""

        try:
            assert P.describe("_described_in_test") == "a one-line description"
            assert P.describe("_docstring_in_test") == "Its docstring."
        finally:
            for n in ("_described_in_test", "_docstring_in_test"):
                registry._REGISTRY.pop(n)
                registry._DESCRIPTIONS.pop(n)

    @pytest.mark.parametrize("seed", [0, 7])
    def test_is_large_is_long(self, seed):
        got = ptrace.paper_trace(seed=seed)
        ref = rtrace.paper_trace(seed=seed)
        assert [ptrace.is_large(j) for j in got] == [rtrace.is_large(j) for j in ref]
        assert [ptrace.is_long(j) for j in got] == [rtrace.is_long(j) for j in ref]
        assert any(ptrace.is_large(j) for j in got) and any(ptrace.is_long(j) for j in got)
        assert not all(ptrace.is_long(j) for j in got)

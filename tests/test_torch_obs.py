"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the same interpreter.

The cases of ``tests/test_obs.py`` (its CPU-time overhead guard aside:
chip_smoke.py prints the observed and unobserved wall times instead) run
on the port, and over the comm x fusion x sched x chaos grid every record
the recorder derives is ``==`` the reference's: the per-job JCT parts, the
gating audit with its ``explain`` terms, the domain timelines, the spans,
the drop counters and the Chrome trace (its ``generator`` tag, which names
the writing module, aside).  An observed run is bit-exact with the
unobserved one.  The closure, conservation and audit-consistency checks of
the reference hold on the port's reports.
"""

import dataclasses
import functools
import json
import math

import pytest

import repro.obs as robs
import repro.scenarios as R
import repro_torch.obs as pobs
import repro_torch.scenarios as P
from repro_torch.obs import DECOMP_CSV_FIELDS, ObsConfig

#: the reference's closure / non-perturbation grid
GRID = [
    ("contended_residue", "ada", "static"),
    ("contended_residue", "srsf1", "static"),
    ("contended_residue", "kway3", "static"),
    ("contended_residue", "ada", "preemptive_srsf"),
    ("fusion_sweep", "ada", "static"),
    ("fusion_sweep", "srsf2", "static"),
    ("preemption_gain", "ada", "preemptive_srsf"),
    ("elastic_surge", "ada", "elastic"),
    ("chaos_recovery_storm", "ada", "static"),
    ("chaos_recovery_storm", "srsf2", "preemptive_srsf"),
]

SIDES = {"port": (P, pobs), "ref": (R, robs)}


def quick(side, name, seed=1):
    mod = SIDES[side][0]
    return mod.get_scenario(name, seed=seed, **mod.QUICK_OVERRIDES[name])


def config(side, kind, **kw):
    obs = SIDES[side][1]
    return obs.ObsConfig.full(**kw) if kind == "full" else obs.ObsConfig(**kw)


@functools.lru_cache(maxsize=None)
def observed(side, name, comm, sched, seed=1, kind="full"):
    """(unobserved, observed) runs of one grid cell on one side."""
    scn = quick(side, name, seed)
    mod = SIDES[side][0]
    off = mod.run_scenario_event(scn, comm=comm, sched=sched)
    on = mod.run_scenario_event(scn, comm=comm, sched=sched, observe=config(side, kind))
    return off, on


def asdicts(xs):
    return [dataclasses.asdict(x) for x in xs]


def assert_same_result(got, ref):
    for f in dataclasses.fields(ref):
        if f.name != "obs":
            assert getattr(got, f.name) == getattr(ref, f.name), f.name


def assert_same_report(got, ref):
    """Every derived view of two reports, ``==``."""
    assert {k: dataclasses.asdict(v) for k, v in got.decomp.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.decomp.items()}
    assert list(got.decomp) == list(ref.decomp)
    assert asdicts(got.audit) == asdicts(ref.audit)
    assert got.timeline == ref.timeline
    assert got.spans == ref.spans
    assert got.job_events == ref.job_events
    assert got.job_meta == ref.job_meta
    assert got.domain_names == ref.domain_names
    assert got.fault_events == ref.fault_events
    for f in ("audit_dropped", "span_dropped", "timeline_dropped", "work_lost_total",
              "makespan"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.mean_parts() == ref.mean_parts()
    assert got.domain_utilization() == ref.domain_utilization()
    assert got.decomposition_csv() == ref.decomposition_csv()
    for f in ("mean_stretch_frac", "mean_gating_frac"):
        a, b = getattr(got, f)(), getattr(ref, f)()
        assert a == b or (math.isnan(a) and math.isnan(b)), f


def trace_without_generator(report):
    trace = report.to_chrome_trace()
    other = dict(trace["otherData"])
    other.pop("generator")
    return {**trace, "otherData": other}


# ---------------------------------------------------------------------------
# Off-path: observe=None is the unobserved engine
# ---------------------------------------------------------------------------


class TestOffPathLock:
    @pytest.mark.parametrize("cell", ["paper/ada", "contended_residue/ada"])
    def test_observe_none_matches_reference(self, cell):
        name, comm = cell.split("/")
        got, ref = (SIDES[s][0].run_scenario_event(quick(s, name, seed=0), comm=comm,
                                                  observe=None) for s in ("port", "ref"))
        assert got.obs is None and ref.obs is None
        assert_same_result(got, ref)

    def test_inactive_config_is_observe_none(self):
        cfg = ObsConfig(decompose=False)
        assert not cfg.active
        res = P.run_scenario_event(quick("port", "contended_residue"), comm="ada", observe=cfg)
        assert res.obs is None

    def test_full_config_is_active(self):
        assert ObsConfig.full().active
        assert ObsConfig().active
        assert dataclasses.asdict(ObsConfig.full()) == dataclasses.asdict(robs.ObsConfig.full())
        assert dataclasses.asdict(ObsConfig()) == dataclasses.asdict(robs.ObsConfig())


# ---------------------------------------------------------------------------
# The grid: bit-exact with the unobserved run, every view == the reference's
# ---------------------------------------------------------------------------


class TestObservedRunIsBitExact:
    @pytest.mark.parametrize("name,comm,sched", GRID)
    def test_observer_does_not_perturb(self, name, comm, sched):
        off, on = observed("port", name, comm, sched)
        assert_same_result(on, off)
        assert on.obs is not None and off.obs is None

    @pytest.mark.parametrize("name,comm,sched", GRID)
    def test_report_equals_reference(self, name, comm, sched):
        (_, got), (_, ref) = observed("port", name, comm, sched), observed("ref", name, comm, sched)
        assert_same_result(got, ref)
        assert_same_report(got.obs, ref.obs)
        assert trace_without_generator(got.obs) == trace_without_generator(ref.obs)
        assert got.obs.to_chrome_trace()["otherData"]["generator"] == "repro_torch.obs.perfetto"

    @pytest.mark.parametrize("name,comm,sched", GRID[:3] + GRID[6:9])
    def test_decompose_only_equals_reference(self, name, comm, sched):
        """The default config (decomposition alone: no audit, so the
        engine's heap gating pass and scalar gate stay on)."""
        (_, got), (_, ref) = (observed(s, name, comm, sched, kind="default")
                              for s in ("port", "ref"))
        assert got.obs.audit == [] and got.obs.spans == [] and got.obs.timeline == []
        assert_same_report(got.obs, ref.obs)


class TestDecompositionClosure:
    @pytest.mark.parametrize("name,comm,sched", GRID)
    def test_parts_sum_to_jct(self, name, comm, sched):
        _, on = observed("port", name, comm, sched)
        obs = on.obs
        assert set(obs.decomp) == set(on.jct)
        for jid, p in obs.decomp.items():
            assert p.jct == pytest.approx(on.jct[jid])
            assert abs(p.parts_sum - p.jct) <= 1e-6
            for f in DECOMP_CSV_FIELDS[2:8]:
                assert getattr(p, f) >= -1e-9, f"negative {f} on job {jid}"
            assert 0.0 <= p.stretch_frac <= 1.0 + 1e-9
            assert 0.0 <= p.gating_frac <= 1.0 + 1e-9

    def test_contended_cell_attributes_stretch_and_gating(self):
        _, on_srsf1 = observed("port", "contended_residue", "srsf1", "static")
        on_srsf2 = P.run_scenario_event(quick("port", "contended_residue"), comm="srsf2",
                                        observe=ObsConfig())
        assert sum(p.gating_wait for p in on_srsf1.obs.decomp.values()) > 0
        assert sum(p.comm_stretch for p in on_srsf2.obs.decomp.values()) > 0

    def test_csv_round_trip(self):
        _, on = observed("port", "contended_residue", "ada", "static")
        lines = on.obs.decomposition_csv().strip().split("\n")
        assert lines[0] == ",".join(DECOMP_CSV_FIELDS)
        assert len(lines) == 1 + len(on.obs.decomp)
        for row in lines[1:]:
            vals = row.split(",")
            assert len(vals) == len(DECOMP_CSV_FIELDS)
            jct, parts = float(vals[1]), [float(v) for v in vals[2:8]]
            assert sum(parts) == pytest.approx(jct, abs=2e-5)

    def test_metrics_row_carries_fractions(self):
        from repro.scenarios.metrics import from_event_result as r_from
        from repro_torch.scenarios.metrics import CSV_FIELDS, from_event_result

        (_, on), (_, ref) = (observed(s, "contended_residue", "ada", "static")
                             for s in ("port", "ref"))
        m = from_event_result(on, scenario="x", seed=1, n_jobs=len(on.jct))
        assert m.stretch_frac == pytest.approx(on.obs.mean_stretch_frac())
        assert len(m.as_csv_row().split(",")) == len(CSV_FIELDS)
        r = r_from(ref, scenario="x", seed=1, n_jobs=len(ref.jct))
        assert (m.stretch_frac, m.gating_frac) == (r.stretch_frac, r.gating_frac)
        assert m.as_csv_row() == r.as_csv_row()


class TestChaosConservation:
    def test_work_lost_equals_recorder_total(self):
        off, on = observed("port", "chaos_recovery_storm", "ada", "static")
        assert off.work_lost_samples > 0
        assert on.obs.work_lost_total == off.work_lost_samples

    def test_fault_events_and_overhead_recorded(self):
        _, on = observed("port", "chaos_recovery_storm", "ada", "static")
        kinds = {k for (_, k, _) in on.obs.fault_events}
        assert "breakdown" in kinds and "repair" in kinds
        hit = [p for p in on.obs.decomp.values() if p.n_preempts > 0]
        assert hit and all(p.overhead_pf > 0 for p in hit)


class TestGatingAudit:
    def test_ada_terms_rederive_decision(self):
        _, on = observed("port", "contended_residue", "ada", "static")
        audit = on.obs.audit
        assert audit and any(not d.accepted for d in audit) and any(d.accepted for d in audit)
        for d in audit:
            assert d.policy == "Ada-SRSF"
            t = d.terms
            assert d.accepted == (t["cap_ok"] and t["ratio"] < t["threshold"])
            assert d.min_old_bytes == pytest.approx(t["min_old_bytes"]) or math.isinf(
                d.min_old_bytes)
            assert -1 <= d.queue_pos <= d.n_waiting

    def test_srsf_terms(self):
        _, on = observed("port", "contended_residue", "srsf1", "static")
        for d in on.obs.audit:
            assert d.terms["n"] == 1
            assert d.accepted == (d.terms["max_concurrent"] + 1 <= 1)

    def test_kway_lookahead_terms(self):
        _, on = observed("port", "contended_residue", "kway3", "static")
        contested = [d for d in on.obs.audit if "t_contend_avg" in (d.terms or {})]
        assert contested
        for d in contested:
            assert d.accepted == (d.terms["t_contend_avg"] < d.terms["t_wait_avg"])

    def test_rejects_precede_the_accept(self):
        _, on = observed("port", "contended_residue", "srsf1", "static")
        by_job = {}
        for d in on.obs.audit:
            by_job.setdefault((d.job_id, d.bucket), []).append(d)
        admitted_after_wait = 0
        for ds in by_job.values():
            assert [d.t for d in ds] == sorted(d.t for d in ds)
            for prev, nxt in zip(ds, ds[1:]):
                if not prev.accepted and nxt.accepted:
                    admitted_after_wait += 1
        assert admitted_after_wait

    @pytest.mark.parametrize("comm", ["ada", "srsf2", "kway2"])
    def test_explain_equals_reference(self, comm):
        """``CommPolicy.explain`` of both packages on the same inputs."""
        from repro.core.contention import ContentionParams as RParams
        from repro.core.schedpolicy import comm_policy_from_name as r_policy
        from repro_torch.core.contention import ContentionParams as PParams
        from repro_torch.core.schedpolicy import CommPolicy, comm_policy_from_name

        assert CommPolicy().explain(1.0, [], 0, PParams()) is None
        cases = [(5e7, [], 0), (5e7, [2e8], 1), (5e8, [1e8, 3e8], 2), (1e6, [0.0, 4e7], 2),
                 (3e8, [1e8, 2e8, 3e8], 3)]
        for new, olds, k in cases:
            got = comm_policy_from_name(comm).explain(new, olds, k, PParams())
            ref = r_policy(comm).explain(new, olds, k, RParams())
            assert got == ref


class TestTimelineAndPerfetto:
    def test_timeline_k_is_conserved(self):
        _, on = observed("port", "contended_residue", "ada", "static")
        obs = on.obs
        assert obs.timeline
        last = {}
        for t, d, k in obs.timeline:
            assert k >= 0
            last[d] = k
        for d, u in obs.domain_utilization().items():
            assert 0.0 <= u["busy_frac"] <= 1.0
            assert u["mean_k"] <= u["peak_k"]
        assert set(obs.domain_names) >= set(last)

    @pytest.mark.parametrize("name", ["paper", "chaos_recovery_storm"])
    def test_perfetto_trace_is_loadable(self, tmp_path, name):
        seed = 2 if name == "chaos_recovery_storm" else 0
        got, ref = (SIDES[s][0].run_scenario_event(quick(s, name, seed), comm="ada",
                                                  observe=config(s, "full"))
                    for s in ("port", "ref"))
        path = tmp_path / f"{name}.perfetto.json"
        written = got.obs.to_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        assert trace == json.loads(json.dumps(written))
        ev = trace["traceEvents"]
        assert ev and isinstance(ev, list)
        assert {"X", "M", "C"} <= {e["ph"] for e in ev}
        for e in ev:
            assert e["ph"] in ("X", "M", "C", "i")
            if e["ph"] == "X":
                assert e["dur"] >= 0 and e["ts"] >= 0
        names = {e["args"]["name"] for e in ev if e["name"] == "process_name"}
        assert any(n.startswith("job ") for n in names)
        if name == "chaos_recovery_storm":
            assert any(e.get("cat") == "fault" for e in ev)
        assert ev == ref.obs.to_chrome_trace()["traceEvents"]
        assert ev == pobs.chrome_trace_events(got.obs)

    def test_spans_match_comm_counters(self):
        off, on = observed("port", "contended_residue", "ada", "static")
        comm_spans = [s for s in on.obs.spans if s[1] < 0 and str(s[2]).startswith("allreduce")]
        assert len(comm_spans) == off.comm_started_contended + off.comm_started_clean


class TestCaps:
    @pytest.mark.parametrize("name", ["contended_residue", "chaos_recovery_storm"])
    def test_tiny_caps_drop_loudly_without_perturbing(self, name):
        caps = dict(audit_cap=7, timeline_cap=5, span_cap=3)
        off = P.run_scenario_event(quick("port", name), comm="ada")
        got, ref = (SIDES[s][0].run_scenario_event(quick(s, name), comm="ada",
                                                  observe=config(s, "full", **caps))
                    for s in ("port", "ref"))
        assert_same_result(got, off)
        obs = got.obs
        assert len(obs.audit) <= 7 and obs.audit_dropped > 0
        assert len(obs.timeline) <= 5 and obs.timeline_dropped > 0
        assert len(obs.spans) <= 3 and obs.span_dropped > 0
        for p in obs.decomp.values():
            assert abs(p.parts_sum - p.jct) <= 1e-6
        assert_same_report(got.obs, ref.obs)

    def test_flush_mid_run_equals_reference(self, monkeypatch):
        """A log folded into the replay mid-run (a tiny flush threshold)
        gives the same report as the reference's flushed the same way."""
        import repro.obs.recorder as rrec
        import repro_torch.obs.recorder as prec

        monkeypatch.setattr(prec, "_FLUSH_AT", 64)
        monkeypatch.setattr(rrec, "_FLUSH_AT", 64)
        got, ref = (SIDES[s][0].run_scenario_event(quick(s, "contended_residue"), comm="srsf2",
                                                  observe=config(s, "full"))
                    for s in ("port", "ref"))
        assert_same_report(got.obs, ref.obs)
        _, unflushed = observed("port", "contended_residue", "srsf2", "static")
        assert asdicts(got.obs.decomp.values()) == asdicts(unflushed.obs.decomp.values())


class TestReport:
    def test_report_helpers_equal_reference(self):
        from repro.obs import report as rrep
        from repro_torch.obs import report as prep

        cols = {}
        for side, rep in (("port", prep), ("ref", rrep)):
            cols[side] = rep.compare_comms(quick(side, "contended_residue"),
                                           comms=("ada", "srsf2"))
        assert cols["port"] == cols["ref"]
        assert prep.mean_parts_table(cols["port"], "t") == rrep.mean_parts_table(cols["ref"], "t")
        assert prep.dominant_component(cols["port"]["ada"], cols["port"]["srsf2"]) == \
            rrep.dominant_component(cols["ref"]["ada"], cols["ref"]["srsf2"])

    def test_explainers_equal_reference(self):
        from repro.obs import report as rrep
        from repro_torch.obs import report as prep

        lines = {"port": [], "ref": []}
        got = prep.explain_fusion_sweep(seed=1, out=lines["port"].append)
        ref = rrep.explain_fusion_sweep(seed=1, out=lines["ref"].append)
        assert lines["port"] == lines["ref"]
        assert got == ref

    def test_obs_package_does_not_export_report(self):
        assert not hasattr(pobs, "observed_run")
        assert sorted(pobs.__all__) == sorted(robs.__all__)

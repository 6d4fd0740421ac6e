"""The CUDA fluid step kernel against the port's plain PyTorch version, on
the card.  CUDA C++ has no CPU mode, so these tests skip where there is no
CUDA device.  The file imports no JAX (the card's machine has none), so it
runs there without the repository's conftest::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_fluidstep_cuda.py

Inputs are made with numpy from a seed.  Bar: every output plane
bit-equal to the plain version (same operations in the same order, no
contracted multiply-adds), int and bool planes exact.  Besides the main
path's shapes, the grid holds the shapes a warp-parallel design gets wrong
(J across warp edges, D at the 64-bit mask's edges, S that is not a
half-warp), unaligned rows, and inputs with no active job, jobs without
members, tied remainders and remainders over 34 decades, and the overlap
plane at the WFBP and exact k-way main path's shapes.  The last tests run
small batches through ``simulate_traces_batched`` with each chunk replayed
from a CUDA graph and eagerly (and, on the WFBP and k-way paths, on the
CPU): identical results, and the kernel counted once per executed tick.
"""

import numpy as np
import pytest
import torch

import repro_torch.scenarios as P
from repro_torch.core import fluidsim
from repro_torch.kernels.fluidstep import fluid_step_core
from repro_torch.kernels.fluidstep.kernel import MAX_DOMAINS, fluid_step_core_cuda

B, ETA = 8.53e-10, 1.706e-10
NAMES = ("loads", "member", "active", "rem", "bw", "oversub")


def _rand_inputs(seed, lanes, n_jobs, n_servers, n_domains):
    rng = np.random.default_rng(seed)
    return {
        "loads": rng.random((lanes, n_jobs, n_domains)) < 0.35,
        "member": (rng.random((lanes, n_jobs, n_servers)) < 0.4).astype(np.float32),
        "active": rng.random((lanes, n_jobs)) < 0.5,
        "rem": rng.uniform(0.05, 80.0, (lanes, n_jobs)).astype(np.float32),
        "bw": rng.uniform(0.4, 2.5, n_servers).astype(np.float32),
        "oversub": rng.uniform(1.0, 4.0, n_domains).astype(np.float32),
    }


def _special_inputs(case, seed=7, lanes=3, n_jobs=45, n_servers=16, n_domains=20):
    x = _rand_inputs(seed, lanes, n_jobs, n_servers, n_domains)
    rng = np.random.default_rng(seed + 1)
    if case == "no_active_lane":
        x["active"][1] = False
    elif case == "zero_member_rows":
        x["member"][:, ::2] = 0.0
    elif case == "tied_rem":
        x["rem"] = rng.choice(np.float32([0.5, 2.5, 7.0]), (lanes, n_jobs))
    elif case == "rem_range":
        x["rem"] = (10.0 ** rng.uniform(-30, 4, (lanes, n_jobs))).astype(np.float32)
    elif case == "all_loaded":
        x["loads"][:] = True
        x["active"][:] = True
    else:
        raise ValueError(case)
    return x


def _run(x, device, **kw):
    out = fluid_step_core(*[torch.as_tensor(x[k]).to(device) for k in NAMES],
                          b=B, eta=ETA, **kw)
    return {k: (None if v is None else v.cpu().numpy()) for k, v in out.items()}


def _assert_bit_equal(x, device, need_overlap):
    got = _run(x, device, need_overlap=need_overlap, impl="cuda")
    torch.cuda.synchronize()
    plain = _run(x, device, need_overlap=need_overlap, impl="ref")
    for k, v in plain.items():
        if v is None:
            assert got[k] is None
        else:
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)  # bit-equal


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fluid step kernel is CUDA C++ "
                    "and has no CPU mode (run `pytest -m cuda` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaKernel:
    @pytest.mark.parametrize("n_jobs", [8, 40, 160, 256])
    @pytest.mark.parametrize("n_domains", [16, 20, MAX_DOMAINS])
    @pytest.mark.parametrize("lanes", [1, 8])
    @pytest.mark.parametrize("need_overlap", [False, True])
    def test_kernel_matches_plain(self, cuda_device, n_jobs, n_domains, lanes, need_overlap):
        x = _rand_inputs(n_jobs + n_domains + lanes, lanes, n_jobs, 16, n_domains)
        launches = fluid_step_core_cuda.launches
        got = _run(x, cuda_device, need_overlap=need_overlap, impl="cuda")
        torch.cuda.synchronize()
        assert fluid_step_core_cuda.launches == launches + 1
        plain = _run(x, cuda_device, need_overlap=need_overlap, impl="ref")
        for k, v in plain.items():
            if v is None:
                assert got[k] is None
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=k)  # bit-equal

    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("shape", [(8, 48, 8, 8), (8, 160, 16, 16)],
                             ids=["model_zoo", "paper"])
    def test_overlap_plane_at_main_path_shapes(self, cuda_device, shape, seed):
        """The WFBP and exact k-way step's call (``need_overlap=True``) at
        the shapes chip_smoke.py's main path gives it: 8 lanes of 48 jobs
        on 8 servers (model_zoo, NIC-only) and 8 x 160 jobs on 16 servers
        (the paper batch under kway2)."""
        lanes, n_jobs, n_servers, n_domains = shape
        x = _rand_inputs(seed * 31 + n_jobs, lanes, n_jobs, n_servers, n_domains)
        _assert_bit_equal(x, cuda_device, True)

    @pytest.mark.parametrize("n_jobs", [1, 31, 33, 1000])
    @pytest.mark.parametrize("n_domains", [1, 63, MAX_DOMAINS])
    @pytest.mark.parametrize("n_servers", [1, 16, 40])
    @pytest.mark.parametrize("need_overlap", [False, True])
    def test_edge_shapes(self, cuda_device, n_jobs, n_domains, n_servers, need_overlap):
        x = _rand_inputs(n_jobs * 7 + n_domains + n_servers, 3, n_jobs, n_servers, n_domains)
        _assert_bit_equal(x, cuda_device, need_overlap)

    @pytest.mark.parametrize("case", ["no_active_lane", "zero_member_rows", "tied_rem",
                                      "rem_range", "all_loaded"])
    @pytest.mark.parametrize("need_overlap", [False, True])
    def test_special_inputs(self, cuda_device, case, need_overlap):
        _assert_bit_equal(_special_inputs(case), cuda_device, need_overlap)

    @pytest.mark.parametrize("need_overlap", [False, True])
    def test_unaligned_rows(self, cuda_device, need_overlap):
        """Inputs that start one row into a larger tensor: the lanes' byte
        rows begin off any 4-byte boundary."""
        big = _rand_inputs(5, 4, 33, 7, 63)
        views = {k: torch.as_tensor(v).to(cuda_device) for k, v in big.items()}
        for k in ("loads", "member", "active", "rem"):
            views[k] = views[k][1:]
            assert views[k].is_contiguous()
        assert views["loads"].data_ptr() % 4 and views["active"].data_ptr() % 4
        args = [views[k] for k in NAMES]
        got = fluid_step_core(*args, b=B, eta=ETA, need_overlap=need_overlap, impl="cuda")
        want = fluid_step_core(*args, b=B, eta=ETA, need_overlap=need_overlap, impl="ref")
        for k, v in want.items():
            if v is not None:
                assert torch.equal(got[k], v), k

    def test_kernel_rejects_what_it_does_not_take(self, cuda_device):
        x = _rand_inputs(0, 2, 12, 6, MAX_DOMAINS + 1)
        with pytest.raises(ValueError, match="domains"):
            _run(x, cuda_device, impl="cuda")
        x = _rand_inputs(0, 2, 12, 6, 9)
        x["rem"] = x["rem"].astype(np.float64)
        with pytest.raises(ValueError, match="dtype"):
            _run(x, cuda_device, impl="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["", "ref"])
def test_graph_matches_eager(cuda_device, kernel):
    """Three ragged paper seeds through ``simulate_traces_batched``, each
    chunk replayed from a CUDA graph and run eagerly: identical finished
    mask, finish ticks and chunk count, lanes retiring in between (so the
    batch is compacted and captured again), and the kernel counted once
    per executed tick in both runs."""
    kw = dict(min_iters=30, max_iters=120, horizon_s=150.0)
    scns = [P.get_scenario("paper", seed=s, n_jobs=n, **kw) for s, n in enumerate((6, 24, 12))]
    cfg = P.fluid_config(scns[0], comm="ada", placement="lwf", kernel=kernel)
    batch = fluidsim.stack_traces(
        [fluidsim.trace_from_jobs(s.job_list(), device=cuda_device) for s in scns])
    runs = {}
    for graph in (True, False):
        fluid_step_core_cuda.launches = 0
        out = fluidsim.simulate_traces_batched(batch, cfg, _graph=graph)
        torch.cuda.synchronize()
        runs[graph] = (out, fluid_step_core_cuda.launches)
    (g, g_launches), (e, e_launches) = runs[True], runs[False]
    np.testing.assert_array_equal(g["finished"], e["finished"])
    np.testing.assert_array_equal(g["jct"], e["jct"])
    assert g["chunks"] == e["chunks"]
    assert g["finished"].sum() == sum(s.n_jobs for s in scns)
    assert len(g["captures"]) >= 2 and e["captures"] == []
    expected = g["chunks"] * cfg.chunk_steps if kernel == "" else 0
    assert g_launches == e_launches == expected


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name, comm, gating, overrides",
    [("model_zoo", "ada", "fixedpoint", dict(n_jobs=12, min_iters=15, max_iters=60,
                                             horizon_s=600.0, fusion=16e6)),
     ("model_zoo", "kway2", "rounds", dict(n_jobs=12, min_iters=15, max_iters=60,
                                           horizon_s=600.0, fusion="none")),
     ("paper", "kway2", "fixedpoint", dict(n_jobs=24, min_iters=30, max_iters=120,
                                           horizon_s=150.0))],
)
def test_wfbp_and_kway_graph_eager_cpu(cuda_device, name, comm, gating, overrides):
    """WFBP bucket streams (both gating closures) and the exact k-way
    lookahead through ``simulate_traces_batched``: the graph, eager on the
    card and the CPU give identical finished masks, finish ticks and chunk
    counts, and the kernel (with its overlap plane) is counted once per
    executed tick."""
    scns = [P.get_scenario(name, seed=s, **overrides) for s in range(3)]
    runs = {}
    for device, graph in ((cuda_device, True), (cuda_device, False), (torch.device("cpu"), None)):
        cfg = P.fluid_config(scns[0], comm=comm, gating=gating, device=str(device))
        batch = fluidsim.stack_traces([
            fluidsim.trace_from_jobs(s.job_list(), fusion=s.fusion, device=device) for s in scns])
        fluid_step_core_cuda.launches = 0
        runs[(device.type, graph)] = (fluidsim.simulate_traces_batched(batch, cfg, _graph=graph),
                                      fluid_step_core_cuda.launches)
    g, g_launches = runs[("cuda", True)]
    for key in (("cuda", False), ("cpu", None)):
        other, launches = runs[key]
        np.testing.assert_array_equal(other["finished"], g["finished"], err_msg=str(key))
        np.testing.assert_array_equal(other["jct"], g["jct"], err_msg=str(key))
        assert other["chunks"] == g["chunks"], key
    assert g["finished"].sum() == sum(s.n_jobs for s in scns)
    assert g_launches == runs[("cuda", False)][1] == g["chunks"] * 256
    assert runs[("cpu", None)][1] == 0

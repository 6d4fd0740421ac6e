"""No rank of a sharded step does work that another rank of its "model"
group also does: every product of a weight that the sharding rules split
over "model" runs on each rank's shard, as GSPMD partitions the
reference's step.

For one train and one prefill step of a dense, an MoE, an SSM and an
enc-dec (audio) model, reduced, under the dry-run's tuned profile
(``launch/dryrun.py::TUNED_PROFILES``: zero1 with remat "block"; the SSM
model ``dp`` with the batch split over "model" too), the step is traced
with ``launch/hlo.py``'s ``StepTrace`` as rank 0 of a fake (2, 4) ("data",
"model") mesh, and again unsharded as the one rank of a fake (1, 1) mesh
with the same global batch and flags.  Each product that is split runs
on 1/8 of the work on a rank; a product of a weight that the rules leave
replicated over "model" (the dense model's 2 kv heads on the 4-way axis:
``wk`` and ``wv``) runs on the rank's batch shard, 1/2 of it.  So the
rank's counted FLOPs times the 8 ranks equal the unsharded count plus 3
times the replicated products' share of it, within 1 %.  The replicated
products are found in the unsharded trace by their weight's shape (the
forward ``x @ W``, the input's grad ``g @ W^T`` and the weight's grad,
whose output is W's shape).

The traces run in one spawned process (a fake group per mesh), which
imports torch and the port only.  The same process calls
``sharding.rules.sharded_product`` on placements it does not know, which
must raise; and on plain tensors the helper must dispatch the site's own
op, bit for bit.
"""

import json
import math
import os

import pytest
import torch

from _torch_sharding import flops_rows, join, start, weight_matrices, weight_product_flops

#: the model families' reduced archs and the weights their rules leave
#: replicated over a 4-way "model" axis (the allowance)
ARCHS = {"dense": ("llama32_1b", ("wk", "wv")), "moe": ("olmoe_1b_7b", ()),
         "ssm": ("mamba2_130m", ()), "audio": ("seamless_m4t_large_v2", ())}
#: InputShape fields: the global batch splits 8 ways (mamba's batch over
#: the whole mesh)
SHAPES = {"train": ("train_p", 64, 8, "train"), "prefill": ("prefill_p", 64, 8, "prefill")}
MESH = (2, 4)


def products_worker(rank, world, init_file, out_dir, cases):
    """Each (name, arch, InputShape fields) traced on the fake :data:`MESH`
    and on a fake one-rank mesh; writes ``products.json``: per case the
    rank's and the unsharded FLOPs by (op, input shapes), and the shapes of
    the case's replicated weights as matrices."""
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import InputShape

    torch.set_num_threads(1)
    out = {}
    for key, shape in (("sharded", MESH), ("whole", (1, 1))):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
        try:
            mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
            for name, arch, fields, replicated in cases:
                cfg = get_config(arch, reduced=True)
                ishape = InputShape(*fields)
                profile = dryrun.TUNED_PROFILES[arch]
                rec = out.setdefault(name, {})
                try:
                    tr = dryrun._build_and_trace(cfg, ishape, mesh, profile,
                                                 dryrun.run_flags(profile, ishape))
                except Exception:  # reported by the case's test
                    rec["error"] = f"{key}: {traceback.format_exc()[-3000:]}"
                    continue
                rec[key] = flops_rows(tr)
                rec["replicated"] = weight_matrices(cfg, replicated)
            if key == "sharded":
                out["raises"] = _unpinnable(mesh)
                out["row_slice"] = _row_slice(mesh)
        finally:
            dist.destroy_process_group()
    with open(os.path.join(out_dir, "products.json"), "w") as f:
        json.dump(out, f)


def _unpinnable(mesh) -> dict:
    """``sharded_product`` on placements it does not know, on meta shards of
    ``mesh``: the ``ValueError`` message of each, or None where it did not
    raise."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.sharding.rules import local_shape, sharded_product, wrap_local

    def dt(shape, placements):
        local = torch.empty(local_shape(shape, placements, mesh), device="meta")
        return wrap_local(local, mesh, placements, shape)

    x = dt((8, 16), [Replicate(), Replicate()])
    cases = {"partial weight": (x, dt((16, 32), [Replicate(), Partial()])),
             "plain weight": (x, torch.empty(16, 32, device="meta"))}
    res = {}
    for name, (a, w) in cases.items():
        try:
            sharded_product("bd,df->bf", a, w)
            res[name] = None
        except ValueError as e:
            res[name] = str(e)
    return res


def _row_slice(mesh) -> list:
    """The local products of ``sharded_product`` for an input split over
    "model" on its contracted dim beside a weight replicated there (meta
    shards of ``mesh``): [input shapes] of each ``aten.mm``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.sharding.rules import local_shape, sharded_product, wrap_local

    def dt(shape, placements):
        local = torch.empty(local_shape(shape, placements, mesh), device="meta")
        return wrap_local(local, mesh, placements, shape)

    seen = []

    class Products(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ == "mm":
                seen.append([list(a.shape) for a in args[:2]])
            return func(*args, **(kwargs or {}))

    x = dt((8, 16), [Shard(0), Shard(1)])
    w = dt((16, 32), [Replicate(), Replicate()])
    with Products():
        out = sharded_product("bc,cd->bd", x, w, "matmul")
    return seen + [[list(out.shape), [repr(p) for p in out.placements]]]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("products")
    cases = [(f"{fam}_{kind}", arch, SHAPES[kind], rep)
             for fam, (arch, rep) in ARCHS.items() for kind in SHAPES]
    join(start(products_worker, 1, tmp, cases), 600)
    with open(tmp / "products.json") as f:
        return json.load(f)


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("family", list(ARCHS))
def test_no_rank_repeats_another_ranks_products(traced, family, kind):
    rec = traced[f"{family}_{kind}"]
    assert "error" not in rec, rec["error"]
    ranks, model = math.prod(MESH), MESH[1]
    rank = sum(n for _, _, n in rec["sharded"])
    whole = sum(n for _, _, n in rec["whole"])
    repl = weight_product_flops(rec["whole"], rec["replicated"])
    assert bool(repl) == bool(rec["replicated"])
    want = whole + (model - 1) * repl
    top = sorted(rec["sharded"], key=lambda r: -r[2])[:6]
    assert abs(ranks * rank - want) <= 0.01 * want, (
        f"{family} {kind}: {ranks} ranks x {rank:.4e} = {ranks * rank:.4e} FLOPs against "
        f"{want:.4e} ({ranks * rank / want:.3f}x); the rank's largest products: {top}")


def test_unknown_placements_raise(traced):
    """No product is left to DTensor's own plan: a weight ``Partial`` over
    "model", or a plain weight beside a DTensor, raises."""
    raised = traced["raises"]
    assert raised["partial weight"] and "'model'" in raised["partial weight"]
    assert raised["plain weight"] and "DTensor" in raised["plain weight"]


def test_replicated_weight_beside_a_contracted_split(traced):
    """An input split over "model" on the dim it contracts with a weight
    replicated there (the SSM decode's output under ``dp`` with the model
    axis in the batch, as torch 2.11 plans it) runs on the rank's rows of
    the weight, not on the gathered input: each rank of the 4-way group
    multiplies its (4, 4) slice by a (4, 32) slice, and the sum is reduced
    back to the input's batch split."""
    rows = traced["row_slice"]
    assert rows[:-1] == [[[4, 4], [4, 32]]]
    assert rows[-1] == [[8, 32], ["Shard(dim=0)", "Replicate()"]]


@pytest.mark.parametrize("via,op", [("matmul", "aten.mm"), ("no_batch", "aten.bmm"),
                                    ("einsum", "aten.bmm")])
def test_plain_tensors_run_the_sites_op(via, op):
    """On plain tensors the helper dispatches the site's own op, bit for
    bit: ``x @ W`` (``aten.mm``), the marked ``no_batch_einsum`` (the
    ``aten.bmm`` that ``remat="dots"`` saves) or ``torch.einsum``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.common import in_no_batch_einsum, no_batch_einsum
    from repro_torch.sharding.rules import sharded_product

    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in ("mm", "bmm"):
                seen.append((str(func.overloadpacket), in_no_batch_einsum()))
            return func(*args, **(kwargs or {}))

    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 5, 8, generator=gen), torch.randn(8, 3, 4, generator=gen)
    eq = "bsd,dhk->bshk"
    want = {"matmul": lambda: x @ w.reshape(8, 12), "no_batch": lambda: no_batch_einsum(eq, x, w),
            "einsum": lambda: torch.einsum(eq, x, w)}[via]()
    wv = w.reshape(8, 12) if via == "matmul" else w
    with Ops():
        got = sharded_product("bsd,dn->bsn" if via == "matmul" else eq, x, wv, via)
    assert torch.equal(got, want)
    assert seen == [(op, via == "no_batch")]
    with pytest.raises(ValueError, match="unknown via"):
        sharded_product(eq, x, w, "mm")

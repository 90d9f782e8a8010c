"""The port's sharding rules (``repro_torch.shard``), meshes
(``repro_torch.launch.mesh``) and ``compressed_psum`` against the
reference's.

``pspec_for`` and ``make_rules`` are held equal to ``repro.shard.api``'s
on every parameter and cache spec of gemma-2b, mixtral-8x22b and
deepseek-v3-671b (full configs: shapes only) under meshes (1,), (2, 2),
(4, 1), (1, 4) and (2, 4, 4) with a ``pod`` axis, and on the reference
tests' three fake-mesh cases.  ``sharding_for``'s placements are held
to JAX's ``NamedSharding`` device by device: the slice of each tensor
that each mesh position holds, on the suite's 4 CPU devices.
``compressed_psum`` runs on 4 spawned gloo ranks and is held bitwise
against the reference's inside ``shard_map`` over a 4-device ("d",)
mesh, on seeded inputs with zeros, a rank whose shard is all zeros and
a tensor of all zeros (the 1e-12 scale floor).  The same world runs the
three model ops on DTensors (each on its rank's shard, against the plain
op) and checks that a stray DTensor raises.
"""

import numpy as np
import pytest
import torch

from torch_world import jax_free, spawn_world

MESHES = {
    "1": ((1,), ("model",)),
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x4x4": ((2, 4, 4), ("pod", "data", "model")),
}
ARCHS = ("gemma-2b", "mixtral-8x22b", "deepseek-v3-671b")
PSUM_CASES = ("normal with zeros", "one rank all zeros", "all zeros")


class FakeMesh:
    """A mesh's axis sizes only, as the reference's tests fake it."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


class FakeDeviceMesh:
    """What ``local_slices`` reads of a ``DeviceMesh``: the names, sizes
    and this position's coordinate."""

    def __init__(self, shape, axes, coord):
        self.mesh_dim_names, self._shape, self._coord = axes, shape, coord

    def size(self, m):
        return self._shape[m]

    def get_coordinate(self):
        return list(self._coord)


def _specs(arch):
    """Every (shape, logical axes) of the arch's parameters and caches."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.params import spec_leaves
    model = build_model(get_config(arch))
    out = [(s.shape, s.axes) for _, s in spec_leaves(model.specs())]
    shapes = model.cache_shapes(8, 64)
    axes = model.cache_axes()
    leaf = lambda t: isinstance(t, tuple) and all(
        isinstance(x, (int, str, type(None))) for x in t)
    flat_shapes = _tuples(shapes, leaf)
    flat_axes = _tuples(axes, leaf)
    assert len(flat_shapes) == len(flat_axes)
    return out + list(zip(flat_shapes, flat_axes))


def _tuples(tree, leaf):
    if leaf(tree):
        return [tree]
    items = sorted(tree.items()) if isinstance(tree, dict) else \
        list(enumerate(tree))
    return [t for _, v in items for t in _tuples(v, leaf)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pspec_for_matches_the_reference(arch, mesh_name):
    from repro.shard.api import make_rules as jax_rules
    from repro.shard.api import pspec_for as jax_pspec
    from repro_torch.shard import make_rules, pspec_for
    shape, axes = MESHES[mesh_name]
    fake = FakeMesh(shape, axes)
    rules, ref_rules = make_rules(), jax_rules()
    assert rules == ref_rules
    specs = _specs(arch)
    assert len(specs) > 10
    for s, names in specs:
        assert pspec_for(s, names, rules, fake) == \
            tuple(jax_pspec(s, names, ref_rules, fake)), (s, names)
    # The activation specs the models constrain to.
    for s, names in (((8, 64, 16, 128), ("batch", "act_seq", "act_heads",
                                         None)),
                     ((8, 64, 2048), ("batch", "act_seq", None)),
                     ((3, 8, 64), (None, "batch", None)),
                     ((32, 16, 4, 2048), ("moe_dispatch", "experts_act",
                                          None, None))):
        assert pspec_for(s, names, rules, fake) == \
            tuple(jax_pspec(s, names, ref_rules, fake))


def test_the_reference_tests_fake_mesh_cases():
    """``tests/test_train_infra.py``'s three rule cases, and overrides."""
    from repro.shard.api import make_rules as jax_rules
    from repro_torch.shard import make_rules, mesh_axis_size, pspec_for
    rules = make_rules()
    assert pspec_for((8,), ("heads",), rules,
                     FakeMesh((1,), ("model",))) == ()
    assert pspec_for((2, 8, 16, 32), ("layers", "experts", "embed", "ffn"),
                     rules, FakeMesh((4, 2), ("model", "data"))) == \
        (None, "model", "data")
    assert pspec_for((16, 128), ("batch", None), rules,
                     FakeMesh((2, 4, 4), ("pod", "data", "model"))) == \
        (("pod", "data"),)
    assert make_rules(embed=None, batch="data") == jax_rules(
        embed=None, batch="data")
    assert mesh_axis_size(FakeMesh((2, 2), ("data", "model")), "pod") == 1


@pytest.mark.parametrize("mesh_name", ["1", "2x2", "4x1", "1x4"])
def test_sharding_for_holds_the_slices_jax_places(mesh_name):
    """Each mesh position's slice of each gemma-2b parameter under the
    port's placements equals the slice its device holds under JAX's
    ``NamedSharding`` of the reference's spec."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.shard.api import make_rules as jax_rules
    from repro.shard.api import pspec_for as jax_pspec
    from repro_torch.shard import make_rules, pspec_for
    from repro_torch.shard.api import local_slices, placements_for
    shape, axes = MESHES[mesh_name]
    mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:int(
        np.prod(shape))])
    fake = FakeMesh(shape, axes)
    for s, names in _specs("gemma-2b") + [((8, 16, 4), ("batch", None,
                                                         None))]:
        spec = pspec_for(s, names, make_rules(), fake)
        placements = placements_for(spec, axes)
        index = NamedSharding(mesh, P(*jax_pspec(
            s, names, jax_rules(), mesh))).devices_indices_map(s)
        for coord in np.ndindex(*shape):
            want = [sl.indices(n)[:2] for sl, n in
                    zip(index[mesh.devices[coord]], s)]
            got = [(sl.start, sl.stop) for sl in local_slices(
                s, FakeDeviceMesh(shape, axes, coord), placements)]
            assert got == want, (s, names, coord)


def test_constrain_is_the_identity_without_a_mesh():
    from repro_torch.shard import activation_ctx, constrain, make_rules
    x = torch.arange(12.0).reshape(3, 4)
    assert constrain(x, ("batch", None)) is x
    with activation_ctx(FakeMesh((2, 2), ("data", "model")), make_rules()):
        assert constrain(x, ("batch", None)) is x       # a plain tensor


def _psum_inputs():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(4, 33, 7)).astype(np.float32)
    a[rng.random(a.shape) < 0.2] = 0.0
    b = (3.0 * rng.normal(size=(4, 64))).astype(np.float32)
    b[2] = 0.0
    c = np.zeros((4, 16), np.float32)
    return dict(zip(PSUM_CASES, (a, b, c)))


def _psum_worker(rank, out, inputs):
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    mesh = make_mesh((4,), ("d",), device="cpu")
    got = {k: compressed_psum(torch.from_numpy(v[rank]), mesh, "d")
           for k, v in inputs.items()}
    refused = []
    for make in (lambda: make_mesh((8,), ("d",), device="cpu"),
                 lambda: make_production_mesh(device="cpu")):
        try:
            make()
            refused.append(False)
        except RuntimeError:
            refused.append(True)
    if rank == 0:
        torch.save({"psum": got, "refused": refused,
                    "ops": _ops_on_dtensors(rank)}, f"{out}/psum.pt")
    else:
        _ops_on_dtensors(rank)


def _ops_on_dtensors(rank):
    """The model ops on DTensors of a (2, 2) mesh: under the rules each
    runs on the rank's shard of batch and heads and equals the plain op
    on the full tensors; outside ``activation_ctx``, or handed to a
    kernel's wrapper or ``autograd.Function`` directly, a DTensor raises
    (it never reaches the plain version through DTensor's decomposition).
    Returns {check: passed}."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                         flash_attention)
    from repro_torch.kernels.ssm_scan.ops import linear_scan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.shard import activation_ctx, make_rules, sharding_for
    mesh, rules = make_mesh((2, 2), ("data", "model"), device="cpu"), \
        make_rules()
    g = torch.Generator().manual_seed(3)
    rnd = lambda *shape: torch.randn(shape, generator=g)
    # GQA: 4 query heads on the 2-way model axis, 1 KV head (replicated).
    q, k, v = rnd(2, 4, 24, 16), rnd(2, 1, 24, 16), rnd(2, 1, 24, 16)
    qa = ("batch", "act_heads", "act_seq", None)
    ka = ("batch", "act_kv_heads", "act_seq", None)
    put = lambda x, axes: sharding_for(x.shape, axes, rules,
                                       mesh).distribute(x)
    dq, dk, dv = put(q, qa), put(k, ka), put(v, ka)
    res = {}
    with activation_ctx(mesh, rules):
        o = flash_attention(dq, dk, dv, causal=True).full_tensor()
        res["flash"] = torch.allclose(o, flash_attention(q, k, v),
                                      atol=1e-6)
        cq, ck = rnd(2, 4, 16), rnd(2, 1, 30, 16)
        od = decode_attention(put(cq, ("batch", "act_heads", None)),
                              put(ck, ("batch", "act_kv_heads", "cache_seq",
                                       None)),
                              put(ck, ("batch", "act_kv_heads", "cache_seq",
                                       None)), 20).full_tensor()
        res["decode"] = torch.allclose(
            od, decode_attention(cq, ck, ck, 20), atol=1e-6)
        sk, sv = rnd(2, 32, 4, 8), rnd(2, 32, 4, 6)
        ld, gt = -torch.rand(2, 32, 4, generator=g), rnd(2, 32, 4)
        seq, gate = ("batch", "act_seq", "act_heads", None), \
            ("batch", "act_seq", "act_heads")
        y, fin = linear_scan(put(sk, seq), put(sv, seq), put(sk, seq),
                             put(ld, gate), put(gt, gate), chunk=16)
        wy, wfin = linear_scan(sk, sv, sk, ld, gt, chunk=16)
        res["scan"] = (torch.allclose(y.full_tensor(), wy, atol=1e-5)
                       and torch.allclose(fin.full_tensor(), wfin,
                                          atol=1e-5))
    for name, call in (
            ("outside the rules", lambda: flash_attention(dq, dk, dv)),
            ("autograd.Function", lambda: FlashAttention.apply(
                dq, dk, dv, "ref", dict(scale=None, causal=True,
                                        window=None, softcap=None))),
            ("kernel wrapper", lambda: fa.prepare(dq, dk, dv))):
        try:
            call()
            res[f"raises: {name}"] = False
        except TypeError:
            res[f"raises: {name}"] = True
    del rank
    return res


@pytest.fixture(scope="module")
def psum_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("psum_world")
    spawn_world(_psum_worker, 4, out, _psum_inputs())
    assert jax_free(out, 4)
    return torch.load(out / "psum.pt")


@pytest.mark.parametrize("case", PSUM_CASES)
def test_compressed_psum_is_bitwise_the_reference(case, psum_world):
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.distributed.compression import compressed_psum
    x = _psum_inputs()[case]
    mesh = jax.make_mesh((4,), ("d",))
    want = shard_map(lambda a: compressed_psum(a[0], "d")[None], mesh=mesh,
                     in_specs=P("d"), out_specs=P("d"))(x)
    want = np.asarray(want)
    assert all(np.array_equal(want[0], w) for w in want)
    got = psum_world["psum"][case].numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want[0])


def test_make_mesh_refuses_a_mesh_larger_than_the_world(psum_world):
    assert psum_world["refused"] == [True, True]


def test_model_ops_run_on_each_ranks_shard_and_refuse_stray_dtensors(
        psum_world):
    ops = psum_world["ops"]
    assert ops and all(ops.values()), ops

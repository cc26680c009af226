"""The sharded layer of the port (kzg_tpu_torch.parallel) on gloo, CPU.

A module fixture runs worlds of 2 and 4 ranks once each at 2^7
(`tests/torch_parallel_worker.py`, one process a rank, each with a wall
limit) while this process computes the one-device results; each test then
holds one part of the worlds' outputs to them:
  * every sharded transform (ntt, intt, coset_ntt, coset_intt; ntt_t in
    JAX's transposed order, device d holding y at d + R k2, and intt_t its
    inverse) against the port's `Domain`, word for word, and the forward
    ones against the JAX package's `Domain`;
  * the sharded G1 MSM over 125 points and the G2 MSM over 6, padded to the
    world with points at infinity, against the port's `msm` and the oracle,
    in affine form;
  * the commit-witness, batched and evaluation-form steps against the
    port's one-device provers (commit, y, witness; ys, r, witness), the
    evaluation-form step at index 5 also against the eval_2e7 vector's
    bytes, and at index 125 (held by the last rank) on the world of 4;
  * every replicated output equal on every rank, word for word;
  * world 1 in this process (gloo, one rank) against the one-device path.
The `slow` test holds the world of 4 to `kzg_tpu.parallel` on a 4-device
virtual mesh. Tolerance 0 throughout.
"""

import dataclasses
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from kzg_tpu_torch import config
from kzg_tpu_torch.curve import G1, G2, g1_from_device, g2_from_device
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.kzg import KZGProver
from kzg_tpu_torch.kzg.coeff_form import g1_compressed
from kzg_tpu_torch.kzg.eval_form import (
    KZGProverEvalForm, KZGVerifierEvalForm, compute_lagrange_basis_from_secret,
)
from kzg_tpu_torch.kzg.srs import setup
from kzg_tpu_torch.msm import msm
from kzg_tpu_torch.ntt import Domain
from kzg_tpu_torch.oracle import ec_add, ec_mul
from kzg_tpu_torch.parallel.runtime import launch
from kzg_tpu_torch.poly import Polynomial
from torch_parallel_worker import EXP, N_G1, SECRET, VEC, inputs

HERE = os.path.dirname(os.path.abspath(__file__))
N = 1 << EXP
WORLDS = {2: 5, 4: N - 3}  # world size -> the evaluation-form index it opens
GOLD = VEC["configs"]["eval_2e7"]
WORLD_TIMEOUT = 900  # seconds a world may take, its processes killed after


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run its
    plain twins, so they ask for the CPU, on one intra-op thread (the
    ranks run beside this process)."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _fr(ints):
    return torch.from_numpy(FR.encode(ints))


def _affine(curve, jac):
    conv = g1_from_device if curve is G1 else g2_from_device
    return conv(tuple(torch.as_tensor(t)[..., None] for t in jac))[0]


def _run_world(base, world):
    out = base / f"world{world}"
    out.mkdir()
    launch([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
            "--init", f"file://{out / 'store'}", "--eval-index", str(WORLDS[world]),
            "--out", str(out)], world, WORLD_TIMEOUT)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def _one_device(inp):
    """The one-device results the worlds are held to."""
    params = setup(SECRET, N)
    f = Polynomial(_fr(inp["f"]))
    x = inp["point"]
    y = f.eval(x)
    prover = KZGProver(params)
    lag = compute_lagrange_basis_from_secret(SECRET, EXP)
    eprover = KZGProverEvalForm(params, lag)
    evals = _fr(inp["evals"])
    ref = {
        "params": params, "lag": lag, "y": y,
        "commit": prover.commit(f),
        "witness": prover.create_witness(f, (x, y)),
        "ys": [f.eval(v) for v in inp["xs"]],
        "e_commit": eprover.commit(evals),
        "e_witness": {m: eprover.create_witness(evals, m) for m in WORLDS.values()},
    }
    ref["batched"] = prover.create_witness_batched(f, inp["xs"], ref["ys"])
    for curve, pts, key in ((G1, params.gs, "s1"), (G2, params.hs, "s2")):
        k = len(inp[key])
        ref[f"msm_{key}"] = msm(curve, tuple(t[..., :k] for t in pts), _fr(inp[key]))
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(outputs of every rank by world size, one-device results, inputs)."""
    base = tmp_path_factory.mktemp("worlds")
    inp = inputs()
    with ThreadPoolExecutor(len(WORLDS)) as ex:
        futures = {w: ex.submit(_run_world, base, w) for w in WORLDS}
        ref = _one_device(inp)
        worlds = {w: fut.result() for w, fut in futures.items()}
    return worlds, ref, inp


def _blocks(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=-1)


def _replicated(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_transforms_match_domain(run, world):
    worlds, _, inp = run
    ranks = worlds[world]
    x = _fr(inp["x"])
    dom = Domain(EXP)
    for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
        np.testing.assert_array_equal(_blocks(ranks, name), getattr(dom, name)(x).numpy(),
                                      err_msg=name)
    # transposed order: rank d holds y at d + R k2, so block-major
    # position d C + k2 holds the standard output's index d + R k2
    c = N // world
    pos = np.asarray([(k % world) * c + k // world for k in range(N)])
    np.testing.assert_array_equal(_blocks(ranks, "ntt_t")[:, pos], dom.ntt(x).numpy())
    np.testing.assert_array_equal(_blocks(ranks, "intt_t"), x.numpy())


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_transforms_match_jax(run, world):
    import jax.numpy as jnp
    from kzg_tpu.fields import FR as JFR
    from kzg_tpu.ntt import Domain as JDomain

    worlds, _, inp = run
    jdom = JDomain(EXP)
    jx = jnp.asarray(JFR.encode(inp["x"]))
    for name in ("ntt", "coset_ntt"):
        got = unpack16(torch.from_numpy(_blocks(worlds[world], name))).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), np.asarray(getattr(jdom, name)(jx)),
                                      err_msg=name)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_msm_matches_msm_and_oracle(run, world):
    worlds, ref, inp = run
    params = ref["params"]
    for curve, pts, key in ((G1, params.gs, "s1"), (G2, params.hs, "s2")):
        got = _affine(curve, _replicated(worlds[world], f"msm_{key}"))
        assert got == _affine(curve, ref[f"msm_{key}"]), key
        conv = g1_from_device if curve is G1 else g2_from_device
        want = None
        for p, s in zip(conv(tuple(t[..., :len(inp[key])] for t in pts)), inp[key]):
            want = ec_add(want, ec_mul(p, s))
        assert got == want, key


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_commit_witness_step(run, world):
    worlds, ref, _ = run
    ranks = worlds[world]
    assert _affine(G1, _replicated(ranks, "cw_commit")) == _affine(G1, ref["commit"])
    assert FR.decode(torch.from_numpy(_replicated(ranks, "cw_y"))) == [ref["y"]]
    wit = _replicated(ranks, "cw_wit")
    assert _affine(G1, wit) == _affine(G1, ref["witness"])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_batched_witness_step(run, world):
    worlds, ref, _ = run
    ranks = worlds[world]
    want = ref["batched"]
    commit = _replicated(ranks, "b_commit")
    assert _affine(G1, commit) == _affine(G1, ref["commit"])
    assert FR.decode(torch.from_numpy(_replicated(ranks, "b_ys"))) == ref["ys"]
    r = torch.from_numpy(_replicated(ranks, "b_r"))
    np.testing.assert_array_equal(r.numpy(), want.r.trimmed().numpy())
    assert _affine(G1, _replicated(ranks, "b_wit")) == _affine(G1, want.w)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_eval_form_step(run, world):
    worlds, ref, inp = run
    ranks, m = worlds[world], WORLDS[world]
    commit = _replicated(ranks, "e_commit")
    assert _affine(G1, commit) == _affine(G1, ref["e_commit"])
    assert FR.decode(torch.from_numpy(_replicated(ranks, "e_y"))) == [inp["evals"][m]]
    wit = _replicated(ranks, "e_wit")
    assert _affine(G1, wit) == _affine(G1, ref["e_witness"][m])
    if m == GOLD["index"]:
        assert g1_compressed(tuple(torch.from_numpy(commit))).hex() == GOLD["commit"]
        assert g1_compressed(tuple(torch.from_numpy(wit))).hex() == GOLD["witness"]
    verifier = KZGVerifierEvalForm(ref["params"], ref["lag"])
    assert verifier.verify_eval((m, inp["evals"][m]), tuple(torch.from_numpy(commit)),
                                tuple(torch.from_numpy(wit)))


def test_world_one_in_process(run, tmp_path):
    """One gloo rank in this process: the transforms and the sharded MSM
    equal the one-device path (R = 1: the 1-point domain is the identity
    and every exchange a copy)."""
    import torch.distributed as dist
    from kzg_tpu_torch.parallel import (
        ShardedDomain, initialize_distributed, make_mesh, make_sharded_msm,
    )

    _, ref, inp = run
    initialize_distributed(init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        sd = ShardedDomain(mesh, "shard", EXP)
        dom = Domain(EXP)
        x = _fr(inp["x"])
        for name in ("ntt", "intt", "coset_ntt", "coset_intt", "ntt_t"):
            want = getattr(dom, name.removesuffix("_t"))(x)
            assert torch.equal(getattr(sd, name)(sd.shard(x)), want), name
        assert torch.equal(sd.intt_t(dom.ntt(x)), x)
        pts = tuple(t[..., :N_G1] for t in ref["params"].gs)
        got = make_sharded_msm(mesh, "shard")(pts, _fr(inp["s1"]))
        assert _affine(G1, got) == _affine(G1, ref["msm_s1"])
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_world_four_matches_jax_parallel(run):
    """The world of 4 against `kzg_tpu.parallel` on a 4-device virtual mesh:
    ntt_t word for word, and the commit-witness step's y word for word and
    its points in affine form."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from kzg_tpu.curve import G1 as JG1
    from kzg_tpu.fields import FR as JFR
    from kzg_tpu.kzg import setup as jsetup
    from kzg_tpu.parallel import ShardedDomain as JSharded
    from kzg_tpu.parallel import make_commit_witness_step as jstep

    worlds, ref, inp = run
    ranks = worlds[4]
    mesh = Mesh(np.array(jax.devices()[:4]), ("shard",))
    jsd = JSharded(mesh, "shard", EXP)
    jt = np.asarray(jsd.ntt_t(jsd.shard(jnp.asarray(JFR.encode(inp["x"])))))
    got = unpack16(torch.from_numpy(_blocks(ranks, "ntt_t"))).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, jt)

    params = jsetup(SECRET, N)
    step = jstep(mesh, "shard", EXP)
    coeffs = jax.device_put(jnp.asarray(JFR.encode(inp["f"])), step.point_sharding)
    commit, y, wit = step(jax.device_put(params.gs[0], step.point_sharding),
                          jax.device_put(params.gs[1], step.point_sharding),
                          jax.device_put(params.gs[2], step.inf_sharding), coeffs,
                          jnp.asarray(JFR.encode([inp["point"]])))
    port_y = unpack16(torch.from_numpy(_replicated(ranks, "cw_y"))).numpy().astype(np.uint32)
    np.testing.assert_array_equal(port_y, np.asarray(y))
    for key, jac in (("cw_commit", commit), ("cw_wit", wit)):
        jx, jy, jinf = (np.asarray(t) for t in JG1.to_affine(tuple(t[..., None] for t in jac)))
        px, py, pinf = G1.to_affine(tuple(torch.from_numpy(t)[..., None]
                                          for t in _replicated(ranks, key)))
        assert bool(jinf[0]) == bool(pinf[0])
        np.testing.assert_array_equal(unpack16(px).numpy().astype(np.uint32), jx)
        np.testing.assert_array_equal(unpack16(py).numpy().astype(np.uint32), jy)


def test_launch_kills_a_world_past_its_limit():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ran past 1"):
        launch([sys.executable, "-c", "import time; time.sleep(60)"], 2, 1)
    assert time.monotonic() - t0 < 30


def test_launch_reports_a_failed_rank():
    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1':\n"
            "    sys.exit('rank one gives up')\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] of 2(.|\n)*rank one gives up"):
        launch([sys.executable, "-c", code], 2, 60)
    assert time.monotonic() - t0 < 30
    assert launch([sys.executable, "-c", "import os; print(os.environ['RANK'])"], 2, 60) \
        == ["0\n", "1\n"]


def test_make_mesh_refuses_more_ranks_than_the_world(tmp_path):
    import torch.distributed as dist
    from kzg_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        assert dist.get_backend() == "gloo"
        initialize_distributed(init_method="file:///nonexistent", world_size=5, rank=3)  # a no-op
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            make_mesh(dataclasses.replace(config.get_config(), mesh_shape=(2,)))
        assert make_mesh().mesh_dim_names == ("shard",)
    finally:
        dist.destroy_process_group()

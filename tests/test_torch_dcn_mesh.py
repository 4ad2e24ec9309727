"""The DCN routes over a model sharded within each pod (in-pod sharding),
on 4 gloo CPU ranks, against the JAX package's ``dcn_send`` and the
emulated route.

The ranks are processes started with ``spawn`` from
``tests/_torch_dcn_mesh_ranks.py`` (which imports no JAX), through a
``file://`` store under the test's temporary directory; they join within
``JOIN_TIMEOUT_S`` or are killed and the tests fail. Each trains on a
``(pod 2, data 1, model 2)`` and a ``(pod 2, data 2, model 1)`` mesh (the
process-group route: each pod's two ranks compute its slice's gradients
on DTensors, each leaf is gathered whole and compressed, the payload
summed over ``pod``), the reduced Qwen2-7B and the reduced xLSTM with 4
layers, with each ``dcn_compression``; the test process runs the
emulated route on one device meanwhile.

What is compared:
- each rank's first-step payloads, leaf by leaf: the gathered pod
  gradient fed to the reference's ``dcn_send`` (int8 with the port's own
  uniforms) gives the rank's payload, and ``topk_ef``'s new residual,
  bit for bit; ``sent + new_err == grads + old_err`` exactly;
- ``none``: the parameters after 3 steps equal (rtol 1e-5; they are
  equal bit for bit) those of the emulated route run by the pod's own
  ``(data, model)`` ranks, the same sharded arithmetic folded in pod
  order; against the emulated route on one device the losses hold rtol
  1e-5, and the parameters the bound of ``tests/test_torch_family_mesh.py``
  (within ``2 * lr`` a step, the mean under 1e-2 ``lr``): the ranks'
  partial sums round the gradients otherwise, and AdamW's normalised
  update turns an element's last-bit difference into up to a whole
  ``lr`` (a difference ROADMAP.md's Queue 3 pins);
- ``topk_ef``'s residuals are this rank's whole ``(1, *shape)`` rows,
  the same on the ranks of a pod;
- ``dcn_bytes`` and ``dcn_raw_bytes`` equal the one-device route's, and
  every rank's parameters are rank 0's.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dcn_mesh_ranks as R
from repro.dist import compression as JC
from repro.dist import sharding as JSH
from repro_torch.dist import compression as C
from repro_torch.dist import sharding as SH

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 300
CASES = [(s, n, m) for s in R.MESHES for n in R.CONFIGS for m in R.METHODS]
CASE_IDS = [f"{'x'.join(map(str, s))}-{n}-{m}" for s, n, m in CASES]
RUNS = [(s, n) for s in R.MESHES for n in R.CONFIGS]
RUN_IDS = [f"{'x'.join(map(str, s))}-{n}" for s, n in RUNS]


@pytest.fixture(autouse=True)
def no_global_mesh():
    JSH.set_mesh(None)
    SH.set_mesh(None)
    yield
    SH.set_mesh(None)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 4 ranks (started first) and the emulated route on one device
    (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("dcn_mesh")
    procs = R.start(out)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        one = {(n, m): R.run_steps(n, m, R.STEPS[m])
               for n in R.CONFIGS for m in R.METHODS}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return {"ranks": R.LM.join(procs, out, deadline), "one": one}


def _reference_send(g, e, key: int, i: int, method: str, monkeypatch):
    """The reference's ``dcn_send`` of one leaf ``g`` (and residual
    ``e``); int8 draws the port's uniforms for leaf ``i`` under
    ``key``."""
    if method == "int8":
        u = C.draw_uniforms(g.shape, C.fold_in(key, i), "cpu").numpy()
        monkeypatch.setattr(jax.random, "uniform",
                            lambda k, shape: jnp.asarray(u))
    sent, new_e = JC.dcn_send([jnp.asarray(g)],
                              [jnp.asarray(e)] if e is not None else {},
                              method, R.TOPK_FRAC,
                              key=jax.random.PRNGKey(0))
    return np.asarray(sent[0]), (np.asarray(new_e[0]) if e is not None
                                 else None)


@pytest.mark.parametrize("shape,name,method", CASES, ids=CASE_IDS)
def test_each_payload_is_the_reference_dcn_send(run, shape, name, method,
                                                monkeypatch):
    for res in run["ranks"]:
        got = res[shape, name, method]
        assert got["route"] == "shard_map"
        sends = got["sends"]
        assert sends and [s[0] for s in sends] == list(range(len(sends)))
        for i, g, e, key, sent, new_e in sends:
            want, want_e = _reference_send(g, e, key, i, method,
                                           monkeypatch)
            np.testing.assert_array_equal(sent, want, err_msg=f"leaf {i}")
            if method == "topk_ef":
                np.testing.assert_array_equal(new_e, want_e)
                # sent + new_err == grads + old_err, exactly
                np.testing.assert_array_equal(sent + new_e, g + e)
            elif method == "none":
                np.testing.assert_array_equal(sent, g)


@pytest.mark.parametrize("shape,name", RUNS, ids=RUN_IDS)
def test_none_matches_the_emulated_route(run, shape, name):
    lr = R.OPT["lr"]
    for res in run["ranks"]:
        got = res[shape, name, "none"]
        sub = res[shape, name, "submesh"]
        assert sub["route"] == "emulated"
        assert [m["loss"] for m in got["metrics"]] == [
            m["loss"] for m in sub["metrics"]]
        for a, b in zip(got["params"], sub["params"], strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
        one = run["one"][name, "none"]
        assert one["route"] == "emulated"
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                                   [m["loss"] for m in one["metrics"]],
                                   rtol=1e-5)
        diffs = [np.abs(a - b) for a, b in zip(got["params"], one["params"],
                                               strict=True)]
        assert max(float(d.max()) for d in diffs) <= (
            2 * lr * R.STEPS["none"] + 1e-6)
        mean = sum(float(d.sum()) for d in diffs) / sum(d.size
                                                        for d in diffs)
        assert mean <= 1e-2 * lr


@pytest.mark.parametrize("shape,name", RUNS, ids=RUN_IDS)
def test_ef_rows_are_whole_and_shared_within_a_pod(run, shape, name):
    one = run["one"][name, "topk_ef"]
    ranks = run["ranks"]
    for res in ranks:
        ef = res[shape, name, "topk_ef"]["ef"]
        assert [e.shape for e in ef] == [(1, *p.shape) for p in
                                         one["params"]]
        assert any(e.any() for e in ef)
        # replicated DTensors on the mesh: each rank holds the whole row
        assert all(res[shape, name, "topk_ef"]["ef_on_mesh"])
        mates = [r for r in ranks if r[shape, "pod"] == res[shape, "pod"]]
        for mate in mates:
            for a, b in zip(ef, mate[shape, name, "topk_ef"]["ef"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,name,method", CASES, ids=CASE_IDS)
def test_dcn_bytes_match_and_every_rank_agrees(run, shape, name, method):
    one = run["one"][name, method]
    ranks = run["ranks"]
    for res in ranks:
        got = res[shape, name, method]
        for m, w in zip(got["metrics"], one["metrics"], strict=True):
            assert m["dcn_bytes"] == w["dcn_bytes"] > 0
            assert m["dcn_raw_bytes"] == w["dcn_raw_bytes"]
        for a, b in zip(got["params"],
                        ranks[0][shape, name, method]["params"]):
            np.testing.assert_array_equal(a, b)

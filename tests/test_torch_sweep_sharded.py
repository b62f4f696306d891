"""The port's ``ShardedScenarioBank`` and scenario meshes against the JAX
package's, at narrow width.

The JAX side runs in a subprocess (this file, run as a program) that
forces 4 host devices before importing JAX, as ``test_torch_dist.py``
runs its own: the reference's ``ShardedScenarioBank`` on a 2-device
``make_scenario_mesh``, the device order of its meshes, and its bank
over a ``SampledHotaSim``. The port side runs on 2 CPU gloo ranks
(``launch.mesh.run_ranks`` on a ("scenario",) mesh), beside it. Both
start from ``bank.init`` of one key on the same batches and round keys
(Fig. 4's four scenarios, C=3 clusters, N=2 clients, batch 8, 3 rounds);
the port's threefry mode is set to the live JAX mode.

Cases and tolerances:
- the sharded bank against the reference's sharded bank: metrics rtol
  1e-4 (float32 matmul and reduction order differ between XLA and
  PyTorch, as in ``test_torch_sweep``), ω relative L2 1e-3;
- the sharded bank against the port's one-process ``ScenarioBank``, and
  over a ``SampledHotaSim``: metrics, states and ``scenario_state`` bit
  for bit (each rank draws the same streams from the shared key);
- a 2-rank checkpoint restoring into the reference's one-process bank
  and the reference bank's checkpoint restoring into the 2 ranks, and a
  2-rank checkpoint restoring into one rank (port to port bit for bit);
- ``run_sweep(scenario_ranks=2)`` writing the one-process sweep's JSON
  (all but the wall time);
- the mesh helpers' rank order and the refusals, against the
  reference's messages.
"""
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.checkpoint.store import flatten
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.tree import state_map, tree_leaves
from repro_torch.convert import bank_state_from_numpy
from repro_torch.core.sampling import SampledHotaSim
from repro_torch.core.sim import HotaSim
from repro_torch.core.sweep import ScenarioBank, ShardedScenarioBank
from repro_torch.data.federated import FederatedBatcher
from repro_torch.data.radcom import (
    N_CLASSES, RadComConfig, TASKS, client_partition, make_radcom_dataset,
)
from repro_torch.experiments import paper_common
from repro_torch.launch.mesh import (
    make_dist_scenario_mesh, make_scenario_mesh, run_ranks,
)
from repro_torch.models.model import build_model
from repro_torch.sharding.mesh_utils import (
    Mesh, bank_rows, bank_sharding, prepend_axis, replicated_sharding,
    scenario_axis_size, scenario_banked_spec, scenario_banked_tree,
)
# one_torch_thread: an autouse fixture
from torch_threads import JAX_XLA_FLAGS, one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))

DIMS = (32, 64, 128, 64, 32, 16)
C, N, B = 3, 2, 8
N_CLS = [N_CLASSES[TASKS[i]] for i in range(N)]
ROUNDS = 3
RANKS = 2
POP = 3                   # clients per (cluster, slot) of the sampled bank
RTOL = 1e-4
SPECS = [dict(weighting=w, sigma2=(s1, 0.75, 1.0))
         for s1 in (2.0, 0.25) for w in ("fedgradnorm", "equal")]


def _batches(n=ROUNDS):
    data = make_radcom_dataset(RadComConfig(n_points=600,
                                            feature_dim=DIMS[0]))
    batcher = FederatedBatcher(client_partition(data, C, N, seed=0), B,
                               seed=1)
    return [batcher.next_stacked() for _ in range(n)]


def _keys(n=ROUNDS):
    return [np.asarray([0, 40 + r], np.uint32) for r in range(n)]


def _plain(x):
    """Named tuples to tuples and arrays to numpy (the reference's state
    pickled without the JAX package's classes)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return None if x is None else np.asarray(x)


# --------------------------------------------------------------------------
# the JAX side (run as a program: 4 forced host devices)
# --------------------------------------------------------------------------

def _jax_main(out_path, ckpt_dir):
    os.environ["XLA_FLAGS"] = JAX_XLA_FLAGS
    import jax
    import jax.numpy as jnp

    import repro.models.model as jmodel
    from repro.common.config import FLConfig as JFL
    from repro.common.config import ModelConfig as JMC
    from repro.common.config import TrainConfig as JTC
    from repro.core.sampling import SampledHotaSim as JSampled
    from repro.core.sim import HotaSim as JSim
    from repro.core.sweep import ShardedScenarioBank as JSharded
    from repro.launch.mesh import make_dist_scenario_mesh as jdist_mesh
    from repro.launch.mesh import make_scenario_mesh as jscen_mesh

    jmodel.PAPER_MLP_DIMS = DIMS
    model = jmodel.Model(JMC(family="mlp"))
    mesh = jscen_mesh(n_devices=RANKS)
    out = {"threefry_partitionable": bool(
        jax.config.jax_threefry_partitionable)}
    batches, keys = _batches(), [jnp.asarray(k) for k in _keys()]
    for tag, sim in (
            ("plain", JSim(model, JFL(n_clusters=C, n_clients=N),
                           JTC(lr=3e-4), N_CLS)),
            ("sampled", JSampled(model, JFL(n_clusters=C, n_clients=N),
                                 JTC(lr=3e-4), N_CLS, population=POP))):
        bank = JSharded(sim, SPECS, mesh)
        st = bank.init(jax.random.PRNGKey(0))
        ms = []
        for (x, y), k in zip(batches, keys):
            st, m = bank.step(st, x, y, k)
            ms.append({n: np.asarray(v) for n, v in m.items()})
        out[tag] = {"metrics": ms, "state": _plain(jax.tree.map(
            np.asarray, st))}
        if tag == "plain":
            bank.save(ckpt_dir, ROUNDS, st)
    out["dist_mesh_ids"] = np.vectorize(lambda d: d.id)(
        jdist_mesh(1, 2).devices).tolist()
    out["scenario_mesh_ids"] = np.vectorize(lambda d: d.id)(
        jscen_mesh().devices).tolist()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# the port side (2 gloo ranks)
# --------------------------------------------------------------------------

def _sim(sampled=False):
    model = build_model(ModelConfig(family="mlp"), DIMS)
    fl = FLConfig(n_clusters=C, n_clients=N)
    if sampled:
        return SampledHotaSim(model, fl, TrainConfig(lr=3e-4), N_CLS,
                              population=POP, device="cpu")
    return HotaSim(model, fl, TrainConfig(lr=3e-4), N_CLS, device="cpu")


def _drive(bank, states, batches, keys):
    ms = []
    for (x, y), k in zip(batches, keys):
        states, m = bank.step(states, x, y, k)
        ms.append(m)
    return states, ms


def _rank(mesh, partitionable, save_dir, ref_dir):
    torch.set_num_threads(1)
    rng.set_threefry_partitionable(partitionable)
    batches, keys = _batches(), _keys()
    out = {"rows": bank_rows(len(SPECS), mesh)}
    for tag in ("plain", "sampled"):
        bank = ShardedScenarioBank(_sim(tag == "sampled"), SPECS, mesh)
        st, ms = _drive(bank, bank.init(rng.PRNGKey(0)), batches, keys)
        out[tag] = {"metrics": ms, "state": st,
                    "scenario_3": bank.scenario_state(st, 3)}
        if tag == "plain":
            bank.save(save_dir, ROUNDS, st)
    # the 2-rank checkpoint into one rank (the mesh's first), which runs
    # one more round as the 2 ranks do; the reference's checkpoint into
    # these ranks
    one = make_scenario_mesh(1, "cpu")
    more = _batches(ROUNDS + 1)[ROUNDS:], _keys(ROUNDS + 1)[ROUNDS:]
    bank = ShardedScenarioBank(_sim(), SPECS, mesh)
    out["plain"]["next"] = _drive(bank, out["plain"]["state"], *more)[0]
    if one is not None:
        bank1 = ShardedScenarioBank(_sim(), SPECS, one)
        out["one_rank"] = _drive(bank1, bank1.restore(save_dir, ROUNDS),
                                 *more)[0]
    _wait_for(ref_dir)
    out["from_ref"] = bank.restore(ref_dir, ROUNDS)
    return out


def _wait_for(ckpt_dir, step=ROUNDS, timeout_s=300):
    """Block until the checkpoint at ``step`` exists (a save publishes its
    directory with the manifest in it, atomically); raise at once if the
    side that writes it failed (``<ckpt_dir>.failed``)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.msgpack")
    t0 = time.time()
    while not os.path.exists(path):
        if os.path.exists(ckpt_dir + ".failed"):
            raise RuntimeError(f"the side writing {ckpt_dir} failed")
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"no checkpoint at {path}")
        time.sleep(0.2)


def _mark_if_failed(proc, ckpt_dir):
    """Wait for the JAX subprocess; if it failed, tell the ranks waiting
    for its checkpoint."""
    if proc.wait():
        open(ckpt_dir + ".failed", "w").close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, once for the module: (reference results, the port's
    ranks' results, the port's one-process bank and its runs, the
    checkpoint directories)."""
    import jax
    tmp = tmp_path_factory.mktemp("sharded")
    ref_path, save_dir, ref_dir = tmp / "ref.pkl", tmp / "port", tmp / "ref"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    log_path = tmp / "ref.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(ref_path),
             str(ref_dir)], env=env, stdout=log, stderr=subprocess.STDOUT)
    watcher = threading.Thread(target=_mark_if_failed,
                               args=(proc, str(ref_dir)))
    watcher.start()
    part = bool(jax.config.jax_threefry_partitionable)
    try:
        ranks = run_ranks(_rank, (part, str(save_dir), str(ref_dir)),
                          shape=(RANKS,), axes=("scenario",), device="cpu")
    except BaseException:
        proc.kill()
        raise
    finally:
        watcher.join(timeout=600)
    assert proc.returncode == 0, log_path.read_text()[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    assert ref["threefry_partitionable"] == part
    prev = rng.set_threefry_partitionable(part)
    one = {}
    for tag in ("plain", "sampled"):
        bank = ScenarioBank(_sim(tag == "sampled"), SPECS)
        one[tag] = _drive(bank, bank.init(rng.PRNGKey(0)), _batches(),
                          _keys())
    rng.set_threefry_partitionable(prev)
    return ref, ranks, one, str(save_dir), str(ref_dir)


def _rel_l2(a, b):
    a = np.concatenate([np.ravel(x) for x in a])
    b = np.concatenate([np.ravel(x) for x in b])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _equal(a, b):
    """Two port states of one structure, bit for bit."""
    state_map(lambda u, v: None if torch.equal(u, v) else pytest.fail(
        f"{tuple(u.shape)} leaf differs"), a, b)


@pytest.mark.parametrize("tag", ["plain", "sampled"])
def test_sharded_bank_matches_reference(runs, tag):
    """Metrics of every round, on every rank, against the reference's
    sharded bank (rtol 1e-4); ω of each rank's rows (relative L2
    1e-3)."""
    ref, ranks, _, _, _ = runs
    for r, res in enumerate(ranks):
        for t, (got, want) in enumerate(zip(res[tag]["metrics"],
                                            ref[tag]["metrics"])):
            for name in ("loss", "p", "fgrad", "grad_norms"):
                assert tuple(got[name].shape) == want[name].shape
                np.testing.assert_allclose(
                    got[name].numpy(), want[name], rtol=RTOL, atol=1e-7,
                    err_msg=f"rank {r} round {t} {name}")
        omega = res[tag]["state"]
        inner = omega.sim if tag == "sampled" else omega
        want = ref[tag]["state"][0] if tag == "sampled" else ref[tag]["state"]
        want = bank_state_from_numpy(want)
        rows = res["rows"]
        assert _rel_l2([l.numpy() for l in tree_leaves(inner.omega)],
                       [l[rows].numpy() for l in tree_leaves(
                           want.omega)]) < 1e-3


@pytest.mark.parametrize("tag", ["plain", "sampled"])
def test_sharded_bank_is_the_one_process_bank(runs, tag):
    """Each rank's rows, every round's global metrics and a scenario's
    state bit for bit the port's one-process ``ScenarioBank``'s."""
    _, ranks, one, _, _ = runs
    st1, ms1 = one[tag]
    for res in ranks:
        for got, want in zip(res[tag]["metrics"], ms1):
            assert sorted(got) == sorted(want)
            for name in want:
                assert torch.equal(got[name], want[name]), name
        rows = res["rows"]
        _equal(res[tag]["state"], state_map(lambda t: t[rows], st1))
        _equal(res[tag]["scenario_3"], state_map(lambda t: t[3], st1))
    assert [res["rows"] for res in ranks] == [slice(0, 2), slice(2, 4)]


def test_checkpoints_move_between_placements(runs):
    """A 2-rank checkpoint restores into one rank, which continues bit for
    bit as the 2 ranks do; the reference's one-process bank reads it;
    the reference's sharded bank's checkpoint restores into the ranks."""
    import jax

    import repro.models.model as jmodel
    from repro.checkpoint.store import checkpoint_metadata
    from repro.common.config import FLConfig as JFL
    from repro.common.config import ModelConfig as JMC
    from repro.common.config import TrainConfig as JTC
    from repro.core.sim import HotaSim as JSim
    from repro.core.sweep import ScenarioBank as JBank
    ref, ranks, one, save_dir, ref_dir = runs
    nxt = state_map(lambda *xs: torch.cat(xs),       # rows in rank order
                    *[r["plain"]["next"] for r in ranks])
    _equal(ranks[0]["one_rank"], nxt)
    st1 = one["plain"][0]
    for res in ranks:
        _equal(res["from_ref"], state_map(lambda t: t[res["rows"]],
                                          bank_state_from_numpy(
                                              ref["plain"]["state"])))
    md = checkpoint_metadata(save_dir, ROUNDS)
    assert md["kind"] == "ShardedScenarioBank" and md["n_scenarios"] == 4
    assert md == dict(checkpoint_metadata(ref_dir, ROUNDS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "PAPER_MLP_DIMS", DIMS)
        jbank = JBank(JSim(jmodel.Model(JMC(family="mlp")),
                           JFL(n_clusters=C, n_clients=N), JTC(lr=3e-4),
                           N_CLS), SPECS)
        got = jbank.restore(save_dir, ROUNDS)
    assert len(jax.tree.leaves(got)) == len(flatten(st1))
    for a, b in zip(jax.tree.leaves(got), flatten(st1)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_restore_refuses_another_scenario_count(runs):
    _, _, _, save_dir, _ = runs
    bank = ScenarioBank(_sim(), SPECS[:2])
    with pytest.raises(ValueError, match="scenario"):
        bank.restore(save_dir, ROUNDS)


def test_run_sweep_on_scenario_ranks(monkeypatch, tmp_path):
    """``run_sweep(scenario_ranks=2)`` writes the one-process sweep's
    results (the wall time aside): the paper's MLP at full width on a
    narrow topology, 2 rounds, one intra-op thread per process."""
    exps = {f"s{i}": dict(sp, sigma2=list(sp["sigma2"]))
            for i, sp in enumerate(SPECS)}
    kw = dict(steps=2, n_clusters=C, n_clients=N, batch=4, log_every=1,
              tune=False, device="cpu", force=True)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the spawned ranks
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = paper_common.run_sweep(
            exps, results_dir=str(tmp_path / "one"), **kw)
        two = paper_common.run_sweep(
            exps, results_dir=str(tmp_path / "two"), scenario_ranks=2, **kw)
    finally:
        torch.set_num_threads(prev)
    for name in exps:
        with open(tmp_path / "two" / f"{name}.json") as f:
            on_disk = json.load(f)
        assert on_disk == json.loads(json.dumps(two[name]))
        a, b = dict(one[name]), dict(two[name])
        assert a.pop("wall_s") > 0 and b.pop("wall_s") > 0
        assert a == b


def test_make_bank_picks_by_the_scenario_mesh():
    """No mesh or a mesh of one rank: the one-process bank; a larger mesh:
    the sharded bank, which refuses an S that the mesh does not divide
    (never the whole bank on every rank)."""
    sim = _sim()
    assert type(paper_common.make_bank(sim, SPECS)) is ScenarioBank
    assert type(paper_common.make_bank(
        sim, SPECS[:3], Mesh((1,), ("scenario",)))) is ScenarioBank
    mesh2 = Mesh((2,), ("scenario",))
    assert type(paper_common.make_bank(sim, SPECS, mesh2)) is \
        ShardedScenarioBank
    with pytest.raises(ValueError, match="must divide evenly"):
        paper_common.make_bank(sim, SPECS[:3], mesh2)


def test_run_sweep_refuses_an_uneven_split(tmp_path):
    """``run_sweep(scenario_ranks=R)`` with an R that does not divide S
    raises the sharded bank's refusal before any rank starts or any
    result is written."""
    exps = {f"s{i}": dict(sp, sigma2=list(sp["sigma2"]))
            for i, sp in enumerate(SPECS[:3])}
    with pytest.raises(ValueError) as got:
        paper_common.run_sweep(exps, steps=1, n_clusters=C, n_clients=N,
                               tune=False, device="cpu", force=True,
                               results_dir=str(tmp_path / "r"),
                               scenario_ranks=2)
    assert str(got.value).startswith(
        "scenario count S=3 must divide evenly over the 2-device scenario "
        "mesh")
    assert not (tmp_path / "r").exists()


def test_run_ranks_leaves_no_process():
    """A program that started ranks leaves no process behind: its fork
    server and resource tracker have exited by the time it has."""
    prog = (
        "import multiprocessing.forkserver as fs, "
        "multiprocessing.resource_tracker as rt\n"
        "from repro_torch.launch.mesh import run_ranks\n"
        "assert len(run_ranks(id, shape=(2,), axes=('scenario',), "
        "device='cpu')) == 2\n"
        "print(fs._forkserver._forkserver_pid, rt._resource_tracker._pid)\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    pids = [int(p) for p in out.stdout.split()]
    assert len(pids) == 2
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_mesh_rank_order_matches_reference(runs):
    """Rank r of a ("scenario", "cluster", "client") mesh sits where the
    reference puts device r: row r // (C·N), row-major."""
    ref = runs[0]
    ids = np.asarray(ref["dist_mesh_ids"])        # (2, 1, 2) device ids
    for r in range(ids.size):
        m = Mesh(ids.shape, ("scenario", "cluster", "client"), rank=r)
        assert ids[m.coords["scenario"], m.coords["cluster"],
                   m.coords["client"]] == r
    assert ref["scenario_mesh_ids"] == list(range(4))
    for r in range(4):
        m = Mesh((2,), ("scenario",), rank=r % 2)
        assert m.coords["scenario"] == r % 2


def test_scenario_layouts():
    specs = {"w": (("client", "cluster"),), "b": ()}
    assert scenario_banked_spec(specs["w"]) == ("scenario",
                                                ("client", "cluster"))
    assert scenario_banked_tree(specs) == {"w": ("scenario",
                                                 ("client", "cluster")),
                                           "b": ("scenario",)}
    assert prepend_axis(specs, None)["b"] == (None,)
    mesh = Mesh((2, 1, 2), ("scenario", "cluster", "client"), rank=3)
    assert scenario_axis_size(mesh) == 2
    assert bank_sharding(mesh) == ("scenario",)
    assert replicated_sharding(mesh) == ()
    assert bank_rows(6, mesh) == slice(3, 6)
    with pytest.raises(ValueError, match="'scenario' axis"):
        scenario_axis_size(Mesh((2, 2), ("cluster", "client")))


def test_refusals_match_reference():
    """The too-few-ranks refusals carry the reference's wording (ranks in
    the world where it counts visible devices), and the divisibility
    refusal is the reference's word for word."""
    import jax  # noqa: F401  (one host device in this process)
    from repro.launch.mesh import make_dist_scenario_mesh as jdist_mesh
    with pytest.raises(ValueError) as want:
        jdist_mesh(1, 2)
    with pytest.raises(ValueError) as got:
        make_dist_scenario_mesh(1, 2, device="cpu")
    assert str(got.value) == str(want.value).replace(
        "devices per", "ranks per").replace(
        "devices are visible", "ranks are in the world")
    with pytest.raises(ValueError, match="needs 2 ranks, but only 1"):
        make_scenario_mesh(2, device="cpu")
    mesh = make_scenario_mesh(device="cpu")
    assert mesh.shape == {"scenario": 1} and mesh.groups is None
    with pytest.raises(ValueError) as got:
        ShardedScenarioBank(_sim(), SPECS[:3], Mesh((2,), ("scenario",)))
    assert str(got.value) == (
        "scenario count S=3 must divide evenly over the 2-device scenario "
        "mesh — pad the bank or shrink the mesh "
        "(make_scenario_mesh(n_ranks=...))")


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])

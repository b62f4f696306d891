"""The port's ``DistScenarioBank`` on 4 CPU gloo ranks against the JAX
package's on 4 forced host devices, at the reference program's config
(``tests/dist_programs/dist_scenario_bank.py``: C=1 cluster, N=2
clients, 4 examples per client of 256 features, S=4 scenarios: σ² 0.5,
σ² 2.0, equal weighting, OTA off; 4 steps), the MLP narrowed behind its
256-feature input.

The JAX side runs in a subprocess (this file, run as a program) that
forces 4 host devices before importing JAX; the port side runs in 4
spawned ranks on a 2-row ("scenario", "cluster", "client") mesh, with a
1-row mesh on its first two ranks (``make_dist_scenario_mesh``'s prefix,
as the reference takes the first devices). Both start from
``bank.init`` of one key, on the same batches and keys, with the port's
threefry mode the JAX default (partitionable). Each side writes a
checkpoint and then waits for the other's, so the two run at once.

Cases and tolerances:
- the bank against the reference's in both count modes ("local": K6's
  plain version, "psum": K5's): metrics rtol 1e-4, the states by the
  reference program's comparator (every entry within 2·steps·lr + 1e-5,
  and under 1e-4 of each leaf's entries beyond 1e-5: an entry whose
  gradient is at float noise moves by ±lr in a first Adam step);
- port against port bit for bit: 2 rows against 1 row, each scenario
  against the 1-D step given that scenario's ``chan`` on the same ranks,
  and a 2-row checkpoint restored into the 1-row bank and continued;
- the fault bank (``dist_faults.py`` part 4: dropout 0 and blackout 1)
  against the reference's: ``skipped`` and ``n_participants`` equal, the
  states by the comparator;
- the reference's checkpoint restored into the port and continued, and
  the port's into the reference, by the comparator; a bank of another S
  refuses a checkpoint, naming the scenario axis;
- ``convert.dist_bank_state_from_numpy`` cuts each rank's stacks, and
  the refusals.
"""
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
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.tree import state_map
from repro_torch.convert import (
    dist_bank_state_from_numpy, dist_bank_state_to_numpy,
)
from repro_torch.core.channel import channel_params
from repro_torch.core.hota_step import make_hota_train_step
from repro_torch.core.sweep import DistScenarioBank
from repro_torch.launch.mesh import make_dist_scenario_mesh, run_ranks
from repro_torch.models.model import build_model
from repro_torch.sharding.mesh_utils import Mesh
# one_torch_thread: an autouse fixture
from torch_threads import JAX_XLA_FLAGS, one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))

C, N, B, D = 1, 2, 4, 256
DIMS = (D, 64, 128, 1152, 64, 32)   # fc2 (128 x 1152) spans two chunks
MAXC = 8
S = 4
STEPS = 4
SAVE_AT = 2
LR = 1e-3
AXES = ("scenario", "cluster", "client")
MODES = ("local", "psum")
FL = dict(n_clusters=C, n_clients=N, noise_std=0.1, tau_h=1)
SCENARIOS = [dict(sigma2=(0.5,)), dict(sigma2=(2.0,)),
             dict(weighting="equal"), dict(ota=False)]
FL_FAULTS = dict(FL, faults=True, weighting="fedgradnorm")
FAULT_SCENARIOS = [dict(dropout_rate=0.0), dict(blackout_rate=1.0)]
FAULT_STEPS = 2


def _inputs():
    r = np.random.default_rng(0)
    return {"x": r.standard_normal((STEPS + SAVE_AT, C * N * B, D)).astype(
                np.float32),
            "y": r.integers(0, MAXC, (STEPS + SAVE_AT, C * N * B)).astype(
                np.int32),
            "keys": [np.asarray([0, 100 + t], np.uint32)
                     for t in range(STEPS + SAVE_AT)],
            "fault_keys": [np.asarray([0, 3 + t], np.uint32)
                           for t in range(FAULT_STEPS)]}


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return None if x is None else np.asarray(x)


def _wait_for(ckpt_dir, step=SAVE_AT, timeout_s=300):
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


# --------------------------------------------------------------------------
# the JAX side (run as a program: 4 forced host devices)
# --------------------------------------------------------------------------

def _jax_main(out_path, ref_ckpt, port_ckpt):
    os.environ["XLA_FLAGS"] = JAX_XLA_FLAGS
    from functools import partial

    import jax

    import repro.core.hota_step as hs
    import repro.models.model as rmodel
    from repro.common.config import FLConfig as JFL
    from repro.common.config import ModelConfig as JMC
    from repro.common.config import TrainConfig as JTC
    from repro.core.sweep import DistScenarioBank as JBank
    from repro.launch.mesh import make_dist_scenario_mesh as jmesh

    rmodel.PAPER_MLP_DIMS = DIMS
    model = rmodel.build_model(JMC(family="mlp", compute_dtype="float32"))
    inp = _inputs()
    mesh2 = jmesh(C, N, n_scenario_devices=2)
    orig = hs.make_packed_omega_gather
    out = {"threefry_partitionable": bool(
        jax.config.jax_threefry_partitionable)}

    def drive(bank, st, steps, keys="keys"):
        ms = []
        for t in steps:
            st, m = bank.step(st, inp["x"][t], inp["y"][t],
                              np.asarray(inp[keys][t]))
            ms.append({k: np.asarray(v) for k, v in m.items()})
        jax.block_until_ready(st)
        return st, ms

    for mode in MODES:
        hs.make_packed_omega_gather = partial(orig, count_mode=mode)
        bank = JBank(model, JFL(**FL), JTC(lr=LR), SCENARIOS, mesh2,
                     loss_kind="cls", n_out=MAXC)
        st0 = bank.init(jax.random.PRNGKey(123))
        st, ms = drive(bank, st0, range(STEPS))
        out[mode] = {"metrics": ms, "state": _plain(jax.tree.map(np.asarray,
                                                                 st))}
        if mode == "local":
            out["state0"] = _plain(jax.tree.map(np.asarray, st0))
            mid, _ = drive(bank, bank.init(jax.random.PRNGKey(123)),
                           range(SAVE_AT))
            bank.save(ref_ckpt, SAVE_AT, mid)
            _wait_for(port_ckpt)
            st, _ = drive(bank, bank.restore(port_ckpt, SAVE_AT),
                          range(SAVE_AT, STEPS))
            out["from_port"] = _plain(jax.tree.map(np.asarray, st))
            fbank = JBank(model, JFL(**FL_FAULTS), JTC(lr=LR),
                          FAULT_SCENARIOS, mesh2, loss_kind="cls",
                          n_out=MAXC)
            st, ms = drive(fbank, fbank.init(jax.random.PRNGKey(0)),
                           range(FAULT_STEPS), "fault_keys")
            out["faults"] = {"metrics": ms, "state": _plain(
                jax.tree.map(np.asarray, st))}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# the port side (4 gloo ranks, 2 scenario rows)
# --------------------------------------------------------------------------

def _model():
    return build_model(ModelConfig(family="mlp", compute_dtype="float32"),
                       DIMS)


def _bank(mesh, mode, fl=FL, scenarios=SCENARIOS):
    return DistScenarioBank(_model(), FLConfig(**fl), TrainConfig(lr=LR),
                            scenarios, mesh, loss_kind="cls", n_out=MAXC,
                            count_mode=mode)


def _drive(bank, mesh, inp, st, steps, keys="keys"):
    me = mesh.axis_index(("cluster", "client"))
    ms = []
    for t in steps:
        x = inp["x"][t].reshape(C * N, B, D)[me]
        y = inp["y"][t].reshape(C * N, B)[me]
        st, m = bank.step(st, x, y, inp[keys][t])
        ms.append({k: v.clone() for k, v in m.items()})
    return st, ms


def _rank(mesh, inp, port_ckpt, ref_ckpt):
    torch.set_num_threads(1)
    rng.set_threefry_partitionable(True)
    row = make_dist_scenario_mesh(C, N, n_scenario_rows=1, device="cpu")
    out = {}
    for mode in MODES:
        bank = _bank(mesh, mode)
        st0 = bank.init(rng.PRNGKey(123))
        st, ms = _drive(bank, mesh, inp, st0, range(STEPS))
        res = {"metrics": ms, "init_stacks": st0,
               "init": dist_bank_state_to_numpy(
                   st0, bank._parts.state_specs, mesh),
               "state": dist_bank_state_to_numpy(
                   st, bank._parts.state_specs, mesh),
               "scenarios": [bank.scenario_state(st, s) for s in range(S)]}
        if row is not None:
            # the same bank on one row (ranks 0-1), and the 1-D step of
            # each scenario on that row's FL mesh
            bank1 = _bank(row, mode)
            st1, ms1 = _drive(bank1, row, inp, bank1.init(rng.PRNGKey(123)),
                              range(STEPS))
            res.update(row_metrics=ms1, row_state=st1)
            init_fn, step_fn, _, _ = make_hota_train_step(
                _model(), row, FLConfig(**FL), TrainConfig(lr=LR),
                loss_kind="cls", n_out=MAXC, count_mode=mode)
            oracle = []
            for sc in SCENARIOS:
                chan = channel_params(FLConfig(**dict(FL, **sc)))
                so = init_fn(rng.PRNGKey(123))
                for t in range(STEPS):
                    x = inp["x"][t].reshape(C * N, B, D)[row.rank]
                    y = inp["y"][t].reshape(C * N, B)[row.rank]
                    so, _ = step_fn(so, x, y, inp["keys"][t], chan)
                oracle.append(so)
            res["oracle"] = oracle
        out[mode] = res

    # checkpoints: the 2-row bank saves, the 1-row bank restores and
    # continues; the reference's checkpoint into the 2-row bank
    bank = _bank(mesh, "local")
    mid, _ = _drive(bank, mesh, inp, bank.init(rng.PRNGKey(123)),
                    range(SAVE_AT))
    bank.save(port_ckpt, SAVE_AT, mid)
    end, _ = _drive(bank, mesh, inp, mid, range(SAVE_AT, STEPS))
    out["ckpt_end"] = bank.scenario_state(end, 0), bank.scenario_state(
        end, 3)
    if row is not None:
        bank1 = _bank(row, "local")
        end1, _ = _drive(bank1, row, inp, bank1.restore(port_ckpt, SAVE_AT),
                         range(SAVE_AT, STEPS))
        out["ckpt_end_row"] = end1
        try:
            _bank(row, "local", scenarios=SCENARIOS[:2]).restore(
                port_ckpt, SAVE_AT)
            out["s_refusal"] = None
        except ValueError as e:
            out["s_refusal"] = str(e)
    _wait_for(ref_ckpt)
    st, _ = _drive(bank, mesh, inp, bank.restore(ref_ckpt, SAVE_AT),
                   range(SAVE_AT, STEPS))
    out["from_ref"] = dist_bank_state_to_numpy(st, bank._parts.state_specs,
                                               mesh)

    # the fault bank
    fbank = _bank(mesh, "local", FL_FAULTS, FAULT_SCENARIOS)
    st0 = fbank.init(rng.PRNGKey(0))
    st, ms = _drive(fbank, mesh, inp, st0, range(FAULT_STEPS), "fault_keys")
    out["faults"] = {"metrics": ms, "state": dist_bank_state_to_numpy(
        st, fbank._parts.state_specs, mesh), "init": st0, "end": st}
    # the shape-only state that restore checks against, of both banks
    out["abstract"] = [
        (_shapes(b._parts.abstract_fn()), _shapes(b._parts.init_fn(
            rng.PRNGKey(0)))) for b in (bank, fbank)]
    return out


def _shapes(state):
    """(shape, dtype, device type) of every leaf of a state."""
    out = []
    state_map(lambda t: out.append((tuple(t.shape), str(t.dtype),
                                    t.device.type)), state)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, once for the module: (reference results, the port's
    ranks' results)."""
    tmp = tmp_path_factory.mktemp("dist_bank")
    ref_path = tmp / "ref.pkl"
    port_ckpt, ref_ckpt = str(tmp / "port"), str(tmp / "ref")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    log_path = tmp / "ref.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(ref_path),
             ref_ckpt, port_ckpt], env=env, stdout=log,
            stderr=subprocess.STDOUT)
    watcher = threading.Thread(target=_mark_if_failed,
                               args=(proc, ref_ckpt))
    watcher.start()
    try:
        ranks = run_ranks(_rank, (_inputs(), port_ckpt, ref_ckpt),
                          shape=(2, C, N), axes=AXES, device="cpu")
    except BaseException:
        proc.kill()         # it would wait for the ranks' checkpoint
        raise
    finally:
        watcher.join(timeout=600)
    assert proc.returncode == 0, log_path.read_text()[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    assert ref["threefry_partitionable"]
    return ref, ranks


def _leaves(x):
    """Leaves of a numpy state (tuples and dicts) in flatten order."""
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, tuple):
        return [v for e in x for v in _leaves(e)]
    return [] if x is None else [np.asarray(x)]


def _states_close(a, b, tag, steps=STEPS, atol=1e-5):
    """The reference program's comparator (``dist_scenario_bank.py``)."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), tag
    for i, (u, v) in enumerate(zip(la, lb)):
        assert u.shape == v.shape, (tag, i)
        da = np.abs(u.astype(np.float64) - v.astype(np.float64))
        if da.size == 0:
            continue
        assert da.max() < 2 * steps * LR + atol, (tag, i, float(da.max()))
        assert float((da > atol).mean()) < 1e-4, (
            tag, i, float((da > atol).mean()))


def _equal(a, b):
    state_map(lambda u, v: None if torch.equal(u, v) else pytest.fail(
        f"{tuple(u.shape)} leaf differs"), a, b)


def test_initial_state_is_the_reference_init(runs):
    """``bank.init`` of the reference's key: exact where the reference's
    leaf is all zeros or ones, else within rtol 1e-5 (the seeded init's
    normal draws round differently, ``test_torch_seeded.NORMAL_RTOL``)."""
    ref, ranks = runs
    got, want = _leaves(ranks[0]["local"]["init"]), _leaves(ref["state0"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if np.all(b == 0) or np.all(b == 1):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_bank_matches_reference(runs, mode):
    ref, ranks = runs
    for r, res in enumerate(ranks):
        for t, (got, want) in enumerate(zip(res[mode]["metrics"],
                                            ref[mode]["metrics"])):
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape == (S,)
                np.testing.assert_allclose(got[k].numpy(), want[k],
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"rank {r} step {t} {k}")
    _states_close(ranks[0][mode]["state"], ref[mode]["state"],
                  f"bank ({mode}) vs reference")
    for res in ranks[1:]:
        for a, b in zip(_leaves(res[mode]["state"]),
                        _leaves(ranks[0][mode]["state"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_two_rows_equal_one_row(runs, mode):
    """The bank on 2 rows and on 1 row, every scenario bit for bit."""
    _, ranks = runs
    for r in (0, 1):
        res = ranks[r][mode]
        for a, b in zip(res["metrics"], res["row_metrics"]):
            for k in a:
                assert torch.equal(a[k], b[k]), k
        for s in range(S):
            _equal(res["scenarios"][s], state_map(lambda t: t[s],
                                                  res["row_state"]))


@pytest.mark.parametrize("mode", MODES)
def test_each_scenario_is_the_1d_step(runs, mode):
    """Scenario s of the bank equals the 1-D distributed step given that
    scenario's ``chan`` on the same ranks, bit for bit."""
    _, ranks = runs
    for r in (0, 1):
        res = ranks[r][mode]
        for s in range(S):
            _equal(res["scenarios"][s], res["oracle"][s])


def test_count_modes_agree(runs):
    _, ranks = runs
    for res in ranks:
        for a, b in zip(res["local"]["metrics"], res["psum"]["metrics"]):
            for k in a:
                assert torch.equal(a[k], b[k]), k
        for s in range(S):
            _equal(res["local"]["scenarios"][s], res["psum"]["scenarios"][s])


def test_fault_bank_matches_reference(runs):
    """``dist_faults.py`` part 4: dropout 0 steps with both clients,
    blackout 1 skips every step and leaves the state as it was."""
    ref, ranks = runs
    for res in ranks:
        for got, want in zip(res["faults"]["metrics"],
                             ref["faults"]["metrics"]):
            assert got["skipped"].tolist() == [0.0, 1.0]
            assert got["n_participants"][0].item() == 2.0
            for k in ("skipped", "n_participants"):
                np.testing.assert_array_equal(got[k].numpy(), want[k])
            for k in ("loss", "p_mean", "fgrad", "gnorm_mean"):
                np.testing.assert_allclose(got[k].numpy(), want[k],
                                           rtol=1e-4, atol=1e-7)
    _states_close(ranks[0]["faults"]["state"], ref["faults"]["state"],
                  "fault bank vs reference", steps=FAULT_STEPS)
    for res in ranks[2:]:       # row 1 holds the blackout scenario
        init, end = res["faults"]["init"], res["faults"]["end"]
        _equal(end._replace(step=init.step), init)
        assert end.step.tolist() == [FAULT_STEPS]


def test_abstract_state_is_the_init_shapes(runs):
    """``abstract_fn`` (what a bank's restore checks against) draws
    nothing and gives ``init_fn``'s leaves, shapes and dtypes on every
    rank, with and without the fault state."""
    _, ranks = runs
    for res in ranks:
        for abstract, init in res["abstract"]:
            assert len(abstract) == len(init) > 0
            assert all(d == "meta" for _, _, d in abstract)
            assert [a[:2] for a in abstract] == [b[:2] for b in init]


def test_checkpoint_two_rows_into_one_row(runs):
    """Saved from 2 rows mid-run, restored into 1 row: both continue bit
    for bit; a bank of another S refuses the checkpoint."""
    _, ranks = runs
    for r in (0, 1):
        s0, s3 = ranks[r]["ckpt_end"]
        row = ranks[r]["ckpt_end_row"]
        _equal(s0, state_map(lambda t: t[0], row))
        _equal(s3, state_map(lambda t: t[3], row))
        assert "scenario" in ranks[r]["s_refusal"]


def test_checkpoints_move_between_packages(runs):
    """The reference's checkpoint restores into the port and the port's
    into the reference; each continues to the uninterrupted run's state
    by the comparator."""
    ref, ranks = runs
    _states_close(ranks[0]["from_ref"], ref["local"]["state"],
                  "reference checkpoint continued in the port")
    _states_close(ref["from_port"], ranks[0]["local"]["state"],
                  "port checkpoint continued in the reference")


def test_converter_cuts_each_ranks_stacks(runs):
    """``dist_bank_state_from_numpy`` of the global state that
    ``dist_bank_state_to_numpy`` gathered gives back each rank's stacks
    bit for bit; of the reference's initial state, the same stacks to the
    seeded init's rtol."""
    ref, ranks = runs
    specs = _bank(Mesh((2, C, N), AXES), "local")._parts.state_specs
    for r in range(4):
        mesh = Mesh((2, C, N), AXES, rank=r)
        mine = ranks[r]["local"]["init_stacks"]
        _equal(dist_bank_state_from_numpy(ranks[0]["local"]["init"], mesh,
                                          r, "cpu", specs), mine)
        got = dist_bank_state_from_numpy(ref["state0"], mesh, r, "cpu",
                                         specs)
        assert got.step.shape == (2,) and got.p.shape == (2, 1)
        state_map(lambda u, v: np.testing.assert_allclose(
            u.numpy(), v.numpy(), rtol=1e-5, atol=0), got, mine)


def test_refusals():
    mesh = Mesh((2, C, N), AXES)
    with pytest.raises(ValueError, match="'scenario' axis"):
        _bank(Mesh((C, N), ("cluster", "client")), "local")
    with pytest.raises(ValueError) as e:
        _bank(mesh, "local", scenarios=SCENARIOS[:3])
    assert str(e.value) == (
        "scenario count S=3 must divide evenly over the 2-row scenario axis "
        "— pad the bank or shrink the mesh")
    with pytest.raises(ValueError, match="mesh has 1 clusters but "
                                         "fl.n_clusters=2"):
        _bank(mesh, "local", fl=dict(FL, n_clusters=2))
    with pytest.raises(ValueError, match="needs 2 ranks per scenario row"):
        make_dist_scenario_mesh(C, N, device="cpu")


if __name__ == "__main__":
    _jax_main(*sys.argv[1:4])

"""More than one device (parallel/mesh.py) on the CPU: a two-process gloo
group against the port's one-process run.

tests/torch_parallel_cases.py runs each case once in this process (one
rank) and once on each rank of a group of two, spawned, joined through a
FileStore under the test's temporary directory (no TCP port to race for
between pytest workers) with a timeout on init_process_group. The G step
with path length, the D step with R1 and ADA's statistic, the
minibatch-std logits, SDF pretraining, a distillation step, the
ray-sharded render with its gradients, and the train, train_encoder,
invert and eval_driving drivers at tiny widths must give what one rank
gives: rtol 1e-5, and an atol of 1e-6 of each array's largest magnitude
(sums of f32 terms in another order), on the averaged gradients, losses,
metrics, pixels and report rows. The one-rank port is held to the JAX
package by the other tests_torch_* files (the same steps, drivers and
render at these widths); the optimizer is compared on shared gradients
(a b1 = 0 Adam's first step can flip a sign near eps): the ranks'
parameters after a G step are the one-rank optimizer's on the group's
averaged gradients.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from nerf_from_image_tpu_torch import arguments
from nerf_from_image_tpu_torch.engine import gan
from nerf_from_image_tpu_torch.parallel import mesh
from tests import torch_parallel_cases as cases
from tests.test_torch_generator import built_once, release_memory  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5  # ATOL of the largest magnitude of each compared array
SSIM_ATOL = 1e-4  # SSIM's f32 floor (E[x^2] - E[x]^2), as in the driving parity tests
# The encoder's gradients against one rank, of their largest magnitude: the
# render's rounding differs at 1e-6 between batch sizes on the CPU, and the
# random MiT-B5 (activations ~40) turns it into ReLU kinks crossed in its
# heads (2.4e-3 measured). The group equals its split run in one process at
# RTOL (test_distillation_equals_its_split_in_one_process).
ENCODER_GRAD_TOL = 5e-3
TIMEOUT_S = 600


def _close(got, want, where, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}", atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{where}[{i}]", atol)
    else:
        a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert a.shape == b.shape, (where, a.shape, b.shape)
        assert np.array_equal(np.isnan(a), np.isnan(b)), where
        a, b = np.nan_to_num(a), np.nan_to_num(b)
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        if "ssim" in where:
            np.testing.assert_allclose(a, b, rtol=0, atol=SSIM_ATOL, err_msg=where)
        elif atol is None:  # a normalized maximum error
            assert np.max(np.abs(a - b)) <= ENCODER_GRAD_TOL * scale, where
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol * scale, err_msg=where)


def _runs(tmp):
    """(one rank's results, [rank 0's, rank 1's]): the group runs in two
    spawned processes while this process runs the one-rank cases."""
    os.environ.pop("NFI_INCEPTION_WEIGHTS", None)
    ctx = mp.start_processes(cases.worker, nprocs=cases.WORLD, join=False, start_method="spawn",
                             args=(str(tmp / "store"), str(tmp / "group"), str(tmp),
                                   TIMEOUT_S))
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        one = cases.run_all(str(tmp / "one"), invert_batch_size=16)
    finally:
        os.chdir(cwd)
        deadline = time.time() + TIMEOUT_S
        while not ctx.join(max(1.0, deadline - time.time())):  # raises if a rank failed
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the ranks did not finish within {TIMEOUT_S} s")
    group = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(cases.WORLD)]
    return one, group


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return built_once(tmp_path_factory, "parallel_runs", _runs)


STEP_CASES = ["g_step", "d_step", "mbstd", "sdf", "coord", "render", "train_driver",
              "train_encoder_driver", "invert_driver", "eval_driving"]


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_ranks_equal_one(runs, case):
    one, group = runs
    for rank, res in enumerate(group):
        got, want = dict(res[case]), dict(one[case])
        if case == "g_step":
            # The parameters: compared on shared gradients below.
            got.pop("params"), want.pop("params")
        if case in ("coord", "train_encoder_driver"):
            _close(got.pop("grads"), want.pop("grads"), f"rank {rank}: {case}.grads", None)
        _close(got, want, f"rank {rank}: {case}")


def test_distillation_equals_its_split_in_one_process(runs):
    """The group's distillation step is its two ranks' steps run in this
    process on their rows and draws, averaged: the all-reduce adds no
    error beyond the order of one sum."""
    _, group = runs
    split = cases.split_in_process(cases.case_coord)
    for res in group:
        _close(res["coord"]["grads"], split["grads"], "coord.grads")
        _close(res["coord"]["losses"], split["losses"], "coord.losses")


def test_ranks_hold_identical_replicas(runs):
    """After the G step both ranks' parameters are equal bit for bit, and
    they are the one-rank optimizer's update on the group's gradients."""
    _, group = runs
    for a, b in zip(group[0]["g_step"]["params"], group[1]["g_step"]["params"]):
        np.testing.assert_array_equal(a, b)
    with cases.tiny_models():
        model, disc = cases._models()
    config = gan.GANTrainConfig(batch_size=cases.B, latent_dim=cases.GEN["latent_dim"])
    opt = gan.make_optimizer(list(model.parameters()), config, config.lr_g)
    opt.step([torch.as_tensor(g) for g in group[0]["g_step"]["grads"]])
    gan.clamp_sdf_params(model, True)
    for p, q in zip(model.parameters(), group[0]["g_step"]["params"]):
        np.testing.assert_array_equal(p.detach().numpy(), q)


def test_driving_report_is_every_object(runs):
    one, group = runs
    assert one["eval_driving"]["objects"] == group[0]["eval_driving"]["objects"] == 4
    # The inverted images are the group's: 8 on each rank as on one.
    assert [r["invert_driver"]["images"] for r in [one] + group] == [8, 8, 8]


def test_shard_batch_contract(monkeypatch):
    """A per-rank slice passed as the global batch and a batch that the
    world size does not divide raise ValueError (not assert: -O keeps
    them)."""
    with pytest.raises(ValueError, match="GLOBAL batch"):
        mesh.shard_batch({"x": np.zeros((2, 3))}, global_batch=4)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    with pytest.raises(ValueError, match="not divisible by 2"):
        mesh.shard_batch({"x": np.zeros((3, 3))}, global_batch=3)
    rows = mesh.shard_batch({"x": np.arange(8), "s": np.float32(2), "n": None}, global_batch=8)
    np.testing.assert_array_equal(rows["x"], [4, 5, 6, 7])
    assert rows["s"] == 2 and rows["n"] is None


@pytest.mark.parametrize("present,missing", [("NFI_NUM_PROCESSES", "NFI_PROCESS_ID"),
                                             ("NFI_PROCESS_ID", "NFI_NUM_PROCESSES"),
                                             ("RANK", "MASTER_ADDR")])
def test_partial_topology_raises(present, missing, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "NFI_NUM_PROCESSES",
              "NFI_PROCESS_ID", "COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    if present.startswith("NFI"):
        monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv(present, "2")
    with pytest.raises(ValueError, match=missing):
        mesh.maybe_init_multihost(arguments.parse_args(["--device", "cpu"]), "cpu")


def test_device_requests_without_a_group_raise(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="--multihost needs a launcher"):
        mesh.maybe_init_multihost(arguments.parse_args(["--multihost"]), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="visible cards"):
            mesh.spawn_local(arguments.parse_args(["--gpus", "2"]), "unused", [])
    assert mesh.spawn_local(arguments.parse_args(["--gpus", "1"]), "unused", []) == (False, None)


def test_gpus_spawns_local_ranks(monkeypatch):
    """--gpus 2 --device cpu with no launcher runs the entry's main in two
    spawned processes that join one group, and returns rank 0's result."""
    for k in ("RANK", "WORLD_SIZE", "COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--gpus", "2", "--device", "cpu"]
    spawned, result = mesh.spawn_local(arguments.parse_args(argv),
                                       "tests.torch_parallel_cases", argv)
    assert spawned and result == {"rank": 0, "world": 2, "backend": "gloo",
                                  "ranks": [0, 1]}

"""The port's updaters, learning-rate policies and gradient normalization
held against ``deeplearning4j_tpu/nn/updaters.py``.

The same gradients (numpy, from a seed) go through both packages' updater
step for 1, 2 and 3 iterations, at the iteration numbers the network passes
(0, 1, 2): the steps and the updater state agree at rtol 1e-5 (float32 in
both; Adam-family ``m / (sqrt(v) + eps)`` rounds differently in the last
bits). Every learning-rate policy agrees at rtol 1e-6 over iterations 0-12,
and every gradient normalization at rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import updaters as ju
from deeplearning4j_tpu_torch.nn import updaters as tu

UPDATERS = ["sgd", "none", "nesterovs", "adam", "adagrad", "rmsprop",
            "adadelta", "adamax", "lars", "lamb"]
POLICIES = ["none", "fixed", "exponential", "inverse", "poly", "sigmoid",
            "step", "schedule", "cosine", "warmup_cosine"]
NORMS = [None, "none", "RenormalizeL2PerLayer", "RenormalizeL2PerParamType",
         "ClipElementWiseAbsoluteValue", "ClipL2PerLayer",
         "ClipL2PerParamType"]
STEP_RTOL = 1e-5


@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("name", UPDATERS)
def test_updater_matches_jax(name, iterations):
    rng = np.random.default_rng(UPDATERS.index(name))
    param = rng.standard_normal((5, 7)).astype(np.float32)
    jspec = ju.UpdaterSpec(name=name, momentum_schedule={"2": 0.5})
    tspec = tu.UpdaterSpec(name=name, momentum_schedule={"2": 0.5})
    jstate = ju.updater_init(jspec, jnp.asarray(param))
    tstate = tu.updater_init(tspec, torch.from_numpy(param))
    assert sorted(jstate) == sorted(tstate)
    for it in range(iterations):
        grad = rng.standard_normal((5, 7)).astype(np.float32)
        grad[0, 0] = 0.0  # Adam-family entries with a zero gradient
        lr = 0.01 * (it + 1)
        jstep, jstate = ju.updater_step_with_param(
            jspec, jnp.asarray(grad), jnp.asarray(param), jstate,
            jnp.float32(lr), it)
        tstep, tstate = tu.updater_step_with_param(
            tspec, torch.from_numpy(grad), torch.from_numpy(param), tstate,
            tu.effective_lr(lr, None, it), it)
        np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep),
                                   rtol=STEP_RTOL, atol=1e-8)
        for key in jstate:
            np.testing.assert_allclose(tstate[key].numpy(),
                                       np.asarray(jstate[key]),
                                       rtol=STEP_RTOL, atol=1e-8)
        param = param - np.asarray(jstep)


def test_unknown_updater_and_param_updaters_raise():
    with pytest.raises(ValueError, match="Unknown updater"):
        tu.updater_init(tu.UpdaterSpec(name="nope"), torch.zeros(2))
    with pytest.raises(ValueError, match="param value"):
        tu.updater_step(tu.UpdaterSpec(name="lamb"), torch.zeros(2), {},
                        tu.effective_lr(0.1, None, 0), 0)


@pytest.mark.parametrize("policy", POLICIES)
def test_lr_policy_matches_jax(policy):
    kw = dict(decay=0.9, power=2.0, steps=4.0, schedule={"3": 0.05, "8": 0.01},
              max_iterations=10)
    for it in range(13):
        ref = ju.effective_lr(0.1, policy, it, **kw)
        got = tu.effective_lr(0.1, policy, it, **kw)
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6,
                                   atol=1e-9)
    with pytest.raises(ValueError, match="Unknown lr policy"):
        tu.effective_lr(0.1, "no_such_policy", 0)


def test_scheduled_value_matches_jax():
    sched = {"2": 0.5, "5": 0.99}
    for it in range(8):
        np.testing.assert_allclose(
            float(tu.scheduled_value(0.9, sched, it)),
            float(ju.scheduled_value(0.9, sched, it)), rtol=1e-7)


@pytest.mark.parametrize("kind", NORMS)
def test_gradient_normalization_matches_jax(kind):
    rng = np.random.default_rng(3)
    grads = {"W": (rng.standard_normal((4, 6)) * 3).astype(np.float32),
             "b": rng.standard_normal(6).astype(np.float32)}
    ref = ju.normalize_gradients({k: jnp.asarray(v) for k, v in grads.items()},
                                 kind, 0.5)
    got = tu.normalize_gradients({k: torch.from_numpy(v)
                                  for k, v in grads.items()}, kind, 0.5)
    for key in grads:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="Unknown gradient normalization"):
        tu.normalize_gradients(got, "no_such_kind", 1.0)

"""The port's losses, optimizers and schedules against the JAX package's
and optax's: mean squared error, online hard keypoint mining (ties,
``max_hard_keypoints`` unset and set, k above the channel count),
categorical cross-entropy; Adam and AMSGrad over 3 steps on the same given
gradients; the learning-rate plateau schedule and early stopping on the
same loss sequences.

Tolerance: losses 1e-6 relative; optimizer parameters 1e-6 absolute after
3 steps at learning rate 1e-2 (the bias corrections are computed in float64
by torch and float32 by optax, ~1e-5 relative in the step, ~1e-7 in the
parameters); schedules exact.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sleap_tpu.config import EarlyStoppingConfig, LearningRateScheduleConfig
from sleap_tpu.training import losses as jl
from sleap_tpu.training.trainer import EarlyStopping as JaxEarlyStopping
from sleap_tpu.training.trainer import ReduceLROnPlateau as JaxReduceLROnPlateau
from sleap_tpu_torch import config as tcfg
from sleap_tpu_torch.training import losses as tl
from sleap_tpu_torch.training.optimizers import AMSGrad, make_optimizer, set_learning_rate
from sleap_tpu_torch.training.trainer import EarlyStopping, ReduceLROnPlateau

torch.set_num_threads(1)


def _pair(seed, shape=(2, 12, 10, 6)):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, shape).astype("f4"), rng.uniform(0, 1, shape).astype("f4")


def _rel(port, ref, tol=1e-6):
    port, ref = float(port), float(ref)
    assert abs(port - ref) <= tol * abs(ref), (port, ref)


def test_mse():
    gt, pr = _pair(0)
    _rel(tl.mse_loss(torch.from_numpy(gt), torch.from_numpy(pr)), jl.mse_loss(gt, pr))


@pytest.mark.parametrize("kw", [
    {},
    {"max_hard_keypoints": 3},
    {"max_hard_keypoints": 1, "min_hard_keypoints": 4},
    {"min_hard_keypoints": 9},  # k above the 6 channels
    {"hard_to_easy_ratio": 1.01, "loss_scale": 2.0},
    {"hard_to_easy_ratio": 100.0},  # no channel hard: k = min_hard_keypoints
])
@pytest.mark.parametrize("ties", [False, True])
def test_ohkm(kw, ties):
    gt, pr = _pair(1)
    pr[..., 1:] *= np.linspace(0.2, 1.5, 5, dtype="f4")  # spread the channel losses
    if ties:  # three channels with the largest loss, equal
        pr[..., 3] = pr[..., 4] = pr[..., 5]
        gt[..., 3] = gt[..., 4] = gt[..., 5]
    ref = jl.compute_ohkm_loss(jnp.asarray(gt), jnp.asarray(pr), **kw)
    _rel(tl.compute_ohkm_loss(torch.from_numpy(gt), torch.from_numpy(pr), **kw), ref)


def test_categorical_crossentropy():
    rng = np.random.default_rng(2)
    gt = np.eye(5, dtype="f4")[rng.integers(0, 5, 7)]
    gt[2] = 0  # no class (track -1)
    pr = rng.dirichlet(np.ones(5), 7).astype("f4")
    pr[0, :] = 0  # clipped at 1e-7
    pr[0, 1] = 1
    _rel(tl.categorical_crossentropy(torch.from_numpy(gt), torch.from_numpy(pr)),
         jl.categorical_crossentropy(jnp.asarray(gt), jnp.asarray(pr)))


@pytest.mark.parametrize("name", ["adam", "amsgrad"])
def test_optimizer_matches_optax(name):
    """3 steps on the same gradients, a later one smaller so that AMSGrad's
    running maximum matters; then a learning-rate change through
    ``param_groups``, as the trainer's schedule makes it."""
    rng = np.random.default_rng(3)
    shapes = {"w": (3, 4), "b": (4,)}
    params = {k: rng.normal(size=s).astype("f4") for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype("f4") for k, s in shapes.items()}
             for scale in (1.0, 3.0, 0.1, 0.5)]
    lrs = (1e-2, 1e-2, 1e-2, 5e-3)

    tx = optax.inject_hyperparams(optax.amsgrad if name == "amsgrad" else optax.adam)(
        learning_rate=lrs[0])
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(name, tparams.values(), lrs[0])
    assert isinstance(opt, AMSGrad if name == "amsgrad" else torch.optim.Adam)
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = jnp.asarray(lr)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        set_learning_rate(opt, lr)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=1e-6)
    moved = max(float(np.abs(tparams[k].detach().numpy() - params[k]).max()) for k in shapes)
    assert moved > 1e-2


def test_amsgrad_differs_from_torch_amsgrad():
    """The reason the port has its own AMSGrad: torch's keeps the maximum of
    the raw second moment, optax the maximum of the corrected one."""
    g1, g2 = torch.tensor([1.0]), torch.tensor([0.01])
    ours = torch.nn.Parameter(torch.zeros(1))
    theirs = torch.nn.Parameter(torch.zeros(1))
    a = AMSGrad([ours], lr=1e-2)
    b = torch.optim.Adam([theirs], lr=1e-2, amsgrad=True)
    for g in (g1, g2):
        ours.grad, theirs.grad = g.clone(), g.clone()
        a.step()
        b.step()
    assert abs(float(ours.detach()) - float(theirs.detach())) > 1e-4


LOSS_SEQUENCES = {
    "falling": [1.0 / (i + 1) for i in range(20)],
    "plateau": [1.0, 0.9, 0.8] + [0.8] * 25,
    "noisy": list(np.random.default_rng(4).uniform(0.4, 0.6, 30)),
    "tiny_gains": [1.0 - 1e-7 * i for i in range(25)],
}


@pytest.mark.parametrize("seq", sorted(LOSS_SEQUENCES))
@pytest.mark.parametrize("kw", [{}, {"plateau_patience": 2, "plateau_cooldown": 1,
                                     "reduction_factor": 0.1, "min_learning_rate": 1e-6},
                                {"reduce_on_plateau": False}])
def test_lr_schedule(seq, kw):
    port = ReduceLROnPlateau(tcfg.LearningRateScheduleConfig(**kw), 1e-3)
    ref = JaxReduceLROnPlateau(LearningRateScheduleConfig(**kw), 1e-3)
    assert [port.update(v) for v in LOSS_SEQUENCES[seq]] == [
        ref.update(v) for v in LOSS_SEQUENCES[seq]]


@pytest.mark.parametrize("seq", sorted(LOSS_SEQUENCES))
@pytest.mark.parametrize("kw", [{}, {"plateau_patience": 3}, {"stop_training_on_plateau": False}])
def test_early_stopping(seq, kw):
    port = EarlyStopping(tcfg.EarlyStoppingConfig(**kw))
    ref = JaxEarlyStopping(EarlyStoppingConfig(**kw))
    assert [port.should_stop(v) for v in LOSS_SEQUENCES[seq]] == [
        ref.should_stop(v) for v in LOSS_SEQUENCES[seq]]

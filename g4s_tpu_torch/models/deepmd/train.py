"""Training loop: weighted energy/force/virial loss, exp-decay LR, Adam,
lcurve output, data-parallel steps (counterpart of
g4s_tpu/models/deepmd/train.py).

Reference semantics:
  - loss (deepmd/deepmd/loss/ener.py:100-215): per-step prefactors
    pref(t) = limit + (start - limit) * lr(t)/start_lr; loss =
    pref_e * mean(dE^2)/natoms + pref_f * mean(dF^2) (+ virial term).
  - LR (deepmd/deepmd/utils/learning_rate.py): exponential decay with
    decay_rate derived from stop_lr at numb_steps.
  - trainer loop (deepmd/deepmd/train/trainer.py:816-1120): lcurve lines
    with rmse_e/_f every disp_freq steps.
  - data parallelism: the reference wraps the optimizer in Horovod
    (trainer.py:685); here each rank takes a shard of the batch and the
    gradients are all-reduced with torch.distributed.

The reference steps with optax.adam on the LR schedule; `Adam` below is
that optimizer written out, with optax's arithmetic and state layout, so a
checkpoint's optimizer state restores in either package. As in the
reference, the whole parameter tree is trained, the normalisation stats
(davg, dstd, fparam_*) included: they are ordinary leaves here too.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from g4s_tpu_torch.ckpt import tree_leaves, tree_unflatten
from g4s_tpu_torch.models.deepmd.model import (ModelSpec, energy_force_virial,
                                               init_params, map_tree)


class LossConfig(NamedTuple):
    start_pref_e: float = 0.02
    limit_pref_e: float = 1.0
    start_pref_f: float = 1000.0
    limit_pref_f: float = 1.0
    start_pref_v: float = 0.0
    limit_pref_v: float = 0.0


class LRConfig(NamedTuple):
    start_lr: float = 1e-3
    stop_lr: float = 3.51e-8
    decay_steps: int = 5000
    numb_steps: int = 1000000

    def decay_rate(self) -> float:
        return (self.stop_lr / self.start_lr) ** (
            self.decay_steps / max(self.numb_steps, 1))

    def lr_at(self, step):
        return self.start_lr * self.decay_rate() ** (step / self.decay_steps)

    def lr_at_count(self, count: int) -> float:
        """lr_at(count) as the reference's optimizer evaluates it: optax
        hands the schedule its int32 update count, which JAX promotes to
        float32, so the step size is a float32 number. XLA on the CPU
        computes it as float32(count) * float32(1/decay_steps), the power
        in float64 rounded to float32, times float32(start_lr)."""
        y = np.float32(count) * np.float32(1.0 / self.decay_steps)
        rate = float(np.float32(self.decay_rate()))
        return float(np.float32(self.start_lr) * np.float32(rate ** float(y)))


# ---------------------------------------------------------------------------
# Adam, as optax.adam(learning_rate=schedule)
# ---------------------------------------------------------------------------


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor      # int32 scalar on the host: updates so far
    mu: object               # first moments, the parameter tree's shape
    nu: object               # second moments


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class Adam:
    """optax.adam(learning_rate=schedule) (b1 0.9, b2 0.999, eps 1e-8) over
    a tree of tensors. The state is optax's chain state,
    (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count)), whose
    leaves flatten as count, mu..., nu..., count. An update with n earlier
    ones takes the step schedule(n) (LRConfig.lr_at_count) and computes,
    per leaf,

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        p += -lr * (mu / (1 - b1^(n+1))) / (sqrt(nu / (1 - b2^(n+1))) + eps)

    in optax's order of operations. The counts stay on the host, so a step
    never waits on the device."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, schedule):
        self.schedule = schedule

    def init(self, params):
        count = torch.zeros((), dtype=torch.int32)
        return (ScaleByAdamState(count, map_tree(torch.zeros_like, params),
                                 map_tree(torch.zeros_like, params)),
                ScaleByScheduleState(count.clone()))

    @torch.no_grad()
    def update(self, grads, state, params):
        """(new params, new state) after one step along grads."""
        adam, sched = state
        lr = self.schedule(int(sched.count))
        b1, b2 = self.b1, self.b2
        n = int(adam.count) + 1
        g = tree_leaves(grads)
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(tree_leaves(adam.mu), b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
            torch._foreach_mul(tree_leaves(adam.nu), b2))
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2 ** n)),
            self.eps)
        step = torch._foreach_div(torch._foreach_div(mu, 1 - b1 ** n), den)
        new = torch._foreach_add(tree_leaves(params),
                                 torch._foreach_mul(step, -lr))
        count = torch.tensor(n, dtype=torch.int32)
        return (tree_unflatten(params, iter(new)),
                (ScaleByAdamState(count, tree_unflatten(params, iter(mu)),
                                  tree_unflatten(params, iter(nu))),
                 ScaleByScheduleState(count.clone())))


def value_and_grad(loss_fn, params, *args):
    """(loss, aux, grads) of loss_fn(params, *args) -> (loss, aux), with
    the gradient of every leaf of params (zeros where the loss does not
    reach it, as jax.grad gives)."""
    live = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, iter(live)), *args)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, live)]
    aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
           for k, v in aux.items()}
    return loss.detach(), aux, tree_unflatten(params, iter(grads))


# ---------------------------------------------------------------------------
# the energy loss and its trainer
# ---------------------------------------------------------------------------


def batched_efv(params, spec: ModelSpec, coord, box, types,
                fparam=None, aparam=None):
    """E, F and W of each frame of a batch, differentiable to the
    parameters through the forces (energy_force_virial's training form)."""
    return energy_force_virial(params, spec, coord, box, types,
                               fparam=fparam, aparam=aparam,
                               create_graph=True)


def pref(start: float, limit: float, frac):
    """A loss prefactor at lr fraction frac = lr(t) / start_lr."""
    return limit + (start - limit) * frac


def _energy_loss_terms(spec, loss_cfg, lr_cfg, params, batch, step):
    """(loss, mean dE^2, mean dF^2, lr) of a batch at step."""
    natoms = batch["coord"].shape[1]
    e, f, v = batched_efv(params, spec, batch["coord"], batch["box"],
                          batch["types"], batch.get("fparam"),
                          batch.get("aparam"))
    lr = lr_cfg.lr_at(step)
    frac = lr / lr_cfg.start_lr
    de2 = torch.mean((e - batch["energy"]) ** 2)
    df2 = torch.mean((f - batch["force"]) ** 2)
    loss = pref(loss_cfg.start_pref_e, loss_cfg.limit_pref_e, frac) \
        * de2 / natoms \
        + pref(loss_cfg.start_pref_f, loss_cfg.limit_pref_f, frac) * df2
    if loss_cfg.start_pref_v or loss_cfg.limit_pref_v:
        dv2 = torch.mean((v - batch["virial"]) ** 2)
        loss = loss + pref(loss_cfg.start_pref_v, loss_cfg.limit_pref_v,
                           frac) * dv2 / natoms
    return loss, de2, df2, lr


def make_loss_fn(spec: ModelSpec, loss_cfg: LossConfig, lr_cfg: LRConfig):
    def loss_fn(params, batch, step):
        loss, de2, df2, lr = _energy_loss_terms(spec, loss_cfg, lr_cfg,
                                                params, batch, step)
        natoms = batch["coord"].shape[1]
        return loss, {"rmse_e": torch.sqrt(de2) / natoms,
                      "rmse_f": torch.sqrt(df2), "lr": lr}
    return loss_fn


def batch_to(raw: dict, like: torch.Tensor) -> dict:
    """A sampled batch of host arrays as tensors on like's device; floating
    arrays take like's dtype (so f64 npy data never drags an f32 run into
    f64), integer ones keep theirs."""
    out = {}
    for k, v in raw.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device=like.device,
                      dtype=like.dtype if t.is_floating_point() else None)
    return out


@dataclasses.dataclass
class Trainer:
    """DPTrainer equivalent: the loss, the optimizer and the update."""

    spec: ModelSpec
    loss_cfg: LossConfig = LossConfig()
    lr_cfg: LRConfig = LRConfig()

    def __post_init__(self):
        self.loss_fn = make_loss_fn(self.spec, self.loss_cfg, self.lr_cfg)
        self.opt = Adam(self.lr_cfg.lr_at_count)

    def init(self, params):
        return self.opt.init(params)

    def _update(self, params, opt_state, batch, step):
        loss, aux, grads = value_and_grad(self.loss_fn, params, batch, step)
        params, opt_state = self.opt.update(grads, opt_state, params)
        return params, opt_state, loss, aux

    def train(self, params, data, numb_steps: int, *, disp_freq: int = 100,
              lcurve_path: Optional[str] = None, callback=None):
        """numb_steps updates from a fresh optimizer state (step and LR
        count from 0, as the reference's train does on every call)."""
        opt_state = self.init(params)
        lcurve = open(lcurve_path, "w") if lcurve_path else None
        try:
            if lcurve:
                lcurve.write("# step rmse_e rmse_f lr wall\n")
            t0 = time.time()
            like = tree_leaves(params)[0]
            for step in range(numb_steps):
                batch = batch_to(data.sample_batch(), like)
                params, opt_state, loss, aux = self._update(
                    params, opt_state, batch, step)
                if step % disp_freq == 0 or step == numb_steps - 1:
                    line = (f"{step} {float(aux['rmse_e']):.6e} "
                            f"{float(aux['rmse_f']):.6e} "
                            f"{float(aux['lr']):.3e} {time.time() - t0:.2f}")
                    if lcurve:
                        lcurve.write(line + "\n")
                        lcurve.flush()
                    if callback:
                        callback(step, aux)
        finally:
            if lcurve:
                lcurve.close()
        return params


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank's contiguous share of a batch's frames (as np.array_split
    deals them); `types` is shared by every frame and stays whole."""
    out = {}
    for k, v in batch.items():
        if k == "types":
            out[k] = v
            continue
        nf = v.shape[0]
        lo = rank * (nf // world) + min(rank, nf % world)
        out[k] = v[lo: lo + nf // world + (rank < nf % world)]
    return out


def make_dp_train_step(spec: ModelSpec, loss_cfg: LossConfig,
                       lr_cfg: LRConfig):
    """Data-parallel train step over the ranks of torch.distributed's
    default group: each rank passes its shard of the global batch
    (shard_batch) and the replicated parameters and Adam state
    (Adam(lr_cfg.lr_at_count).init), and gets back the same update on
    every rank.

    The loss is linear in per-frame means, so each rank's gradient,
    weighted by its share of the frames, summed over the ranks is the
    gradient of the whole batch; the loss likewise, and rmse_e/rmse_f come
    from the summed squared errors, not from averaged square roots.
    step_fn(params, opt_state, batch, step) -> (params, opt_state, loss,
    aux)."""
    import torch.distributed as dist

    opt = Adam(lr_cfg.lr_at_count)

    def loss_fn(params, batch, step):
        loss, de2, df2, lr = _energy_loss_terms(spec, loss_cfg, lr_cfg,
                                                params, batch, step)
        return loss, {"de2": de2, "df2": df2, "lr": lr}

    def step_fn(params, opt_state, batch, step):
        n_local = batch["coord"].shape[0]
        natoms = batch["coord"].shape[1]
        loss, aux, grads = value_and_grad(loss_fn, params, batch, step)
        g = tree_leaves(grads)
        flat = torch.cat([x.reshape(-1) for x in g]
                         + [torch.stack([loss, aux["de2"], aux["df2"]]),
                            loss.new_tensor([float(n_local)])])
        total = flat.clone()
        total[:-1] *= n_local
        dist.all_reduce(total)
        total = total[:-1] / total[-1]
        parts = torch.split(total, [x.numel() for x in g] + [3])
        grads = tree_unflatten(grads, iter(
            p.reshape(x.shape) for p, x in zip(parts, g)))
        loss, de2, df2 = parts[-1]
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss, {
            "rmse_e": torch.sqrt(de2) / natoms, "rmse_f": torch.sqrt(df2),
            "lr": aux["lr"]}

    return step_fn


# ---------------------------------------------------------------------------
# finetuning and multi-task training
# ---------------------------------------------------------------------------


def change_energy_bias(params, spec, data, ntypes: int, *, n_frames: int = 10):
    """Finetune bias correction (trainer.py:1326-1416 init-from-pretrained
    role / deepmd's change_energy_bias): evaluate the pretrained model on
    the NEW data, least-squares the per-type energy residual against type
    counts, and shift each type's final fitting-layer output bias (a
    model with frame or atom parameters evaluates with the system's).
    Returns (params, delta)."""
    like = tree_leaves(params)[0]
    rows, res = [], []
    for s in data.systems:
        nf = min(n_frames, s.nframes)
        count = np.bincount(s.types, minlength=ntypes).astype(np.float64)
        types = torch.as_tensor(np.asarray(s.types), device=like.device)
        for i in range(nf):
            fr = {"coords": s.coord[i], "box": s.box[i]}
            for k in ("fparam", "aparam"):
                if getattr(s, k, None) is not None:
                    fr[k] = getattr(s, k)[i]
            e_pred, _, _ = energy_force_virial(params, spec, types=types,
                                               **batch_to(fr, like))
            rows.append(count)
            res.append(float(s.energy[i]) - float(e_pred))
    delta, *_ = np.linalg.lstsq(np.stack(rows), np.asarray(res), rcond=None)
    # the final fitting layer of each type-net carries the per-type bias
    new_fit = []
    for tc, net in enumerate(params["fit"]):
        b = net["final"]["b"]
        final = dict(net["final"], b=b + torch.as_tensor(
            delta[tc], dtype=b.dtype, device=b.device))
        new_fit.append(dict(net, final=final))
    return dict(params, fit=new_fit), delta


class MultiTaskTrainer:
    """Multi-task training (trainer.py multi-task mode): one SHARED
    descriptor (embedding nets + stats) with per-task fitting heads and
    per-task loss preferences, tasks sampled round-robin. A step updates
    the shared embeddings and stats plus that task's head only; each task
    keeps its own Adam state over everything it trains, and its LR steps
    with its own count (step // ntasks)."""

    def __init__(self, spec, tasks):
        """tasks: list of dicts {name, data, loss_cfg, lr_cfg}."""
        self.spec = spec
        self.tasks = tasks
        self.trainers = [Trainer(spec, t.get("loss_cfg", LossConfig()),
                                 t.get("lr_cfg", LRConfig()))
                         for t in tasks]

    def init_params(self, gen, *, dtype=torch.float64):
        """Shared parts and one head per task, drawn from the
        torch.Generator gen; each head's bias from its task's data."""
        base = init_params(gen, self.spec, dtype=dtype)
        shared = {"embed": base["embed"], "stats": base["stats"]}
        heads = []
        for t in self.tasks:
            p = init_params(gen, self.spec,
                            bias_atom_e=t["data"].energy_bias(
                                self.spec.descriptor.ntypes), dtype=dtype)
            heads.append(p["fit"])
        return {"shared": shared, "heads": heads}

    def train(self, mt_params, numb_steps: int, *, disp_freq: int = 100,
              callback=None):
        states = [tr.init(self.task_params(mt_params, i))
                  for i, tr in enumerate(self.trainers)]
        hist = {t["name"]: [] for t in self.tasks}
        like = tree_leaves(mt_params)[0]
        for step in range(numb_steps):
            i = step % len(self.tasks)
            tr, task = self.trainers[i], self.tasks[i]
            batch = batch_to(task["data"].sample_batch(), like)
            params_i, states[i], loss, aux = tr._update(
                self.task_params(mt_params, i), states[i], batch,
                step // len(self.tasks))
            # write back: shared descriptor parts + this task's head only
            mt_params = {
                "shared": {"embed": params_i["embed"],
                           "stats": params_i["stats"]},
                "heads": [params_i["fit"] if j == i else h
                          for j, h in enumerate(mt_params["heads"])]}
            if step % disp_freq == 0 or step == numb_steps - 1:
                hist[task["name"]].append(float(aux["rmse_f"]))
                if callback:
                    callback(step, task["name"], aux)
        return mt_params, hist

    def task_params(self, mt_params, i: int):
        return {**mt_params["shared"], "fit": mt_params["heads"][i]}

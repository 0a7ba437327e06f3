"""The training harnesses, the counterparts of ``catgen/train/harness.py``:
``GanHarness`` (``cli.train``), ``VHarness`` (``cli.train_v``) and
``PretrainHarness`` (``cli.pretrain_g``).

Each owns the corpus, its models with their train state, the epoch loop
with its per-epoch artifacts, the JSONL metrics, and checkpoints in
catgen's format, filename and cadence. The GAN harness's artifacts are
sample grids stamped with the epoch, the two sanity probes, the NaN check,
the nearest-neighbour distance to the corpus and, when a V checkpoint is
in the save directory, V's rating of the samples, and every
``weights_vis_freq`` epochs D's activation grids; it picks up a pretrained
G from the save directory by filename, resumes, and rebuilds optimizer
states on ``--rebuildOptstate``. With ``collapse_detect`` a collapse
detector (``eval/collapse.py``) watches each epoch and visualization and
stops a collapsed run (``collapse.json``, ``adversarial_collapsed.ckpt``).
``train`` can trace one epoch with ``torch.profiler``. Each epoch's reals
reach the device in one copy, and the epoch's metrics come back in one.

Data parallelism: inside a ``dist.mesh`` group (the CLIs' ``--devices``
and multi-host flags, ``dist/launch.py``) each harness is one rank of
``hc.n_devices``: its models sync their BatchNorm statistics, its steps
are ``dist/dp.py``'s, its state is broadcast from rank 0 at start and on
``resume``, and ``--batchSize`` is per rank. Every rank draws catgen's
global epoch batch from the same numpy stream and keeps its own rows, as
catgen's mesh shards them (across hosts each host draws from its own
slice of the corpus, ``shard_by_process``); each draws its noise, masks
and augmentation from its own stream. Every rank visualizes, so that the
streams stay in step, but only rank 0 writes checkpoints, grids, metrics
and the collapse report, and rank 0's collapse verdict stops every rank.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from catgen_torch import models
from catgen_torch.core.module import reset_parameters
from catgen_torch.core.random import Draws
from catgen_torch.data import color as colorlib
from catgen_torch.data.loader import ImageDataset, rank_rows
from catgen_torch.dist import dp, mesh
from catgen_torch.eval.collapse import (CollapseDetector, per_pixel_std,
                                        sat_fraction)
from catgen_torch.io.activations import save_activation_grids
from catgen_torch.io import checkpoint as ckpt
from catgen_torch.io.convert import (train_state_from_leaves,
                                     train_state_to_leaves,
                                     variables_from_leaves,
                                     variables_to_leaves)
from catgen_torch.io.grids import save_grid
from catgen_torch.io.metrics import MetricsLogger, confusion_summary
from catgen_torch.sample.sampler import nn_l2_mean, self_nn_mean
from catgen_torch.train import gan, pretrainer, synthetic, v_trainer

# catgen's overlay bank for the V harness: 1000 masks of 10000 walk steps
OVERLAY_BANK = dict(n=1000, n_points=10000)


@dataclasses.dataclass
class HarnessConfig:
    """catgen's harness knobs, field for field: checkpoints store them
    under ``config`` and both packages read them back."""
    save_dir: str = "logs"
    save_freq: int = 30
    n_epoch: int = 1000           # examples per epoch
    scale: int = 32
    colorspace: str = "rgb"
    noise_dim: int = 100
    seed: int = 1
    n_devices: int = 1
    g_model: str = "default"
    d_model: str = "default"
    v_model: str = "default"
    epochs: Optional[int] = None  # None: run forever, like train.lua
    weights_vis_freq: int = 0
    vis_freq: int = 1             # grids and probes every N epochs
    normalize: bool = False       # [-1, 1] inputs
    collapse_detect: bool = False

    @property
    def image_shape(self):
        return (self.scale, self.scale, colorlib.channels(self.colorspace))


def _acc_window(n_epoch: int, batch_size: int) -> int:
    """train.lua: max(20, min(N_epoch/batchSize, 250))."""
    return int(max(20, min(n_epoch / batch_size, 250)))


def data_parallel(hc: HarnessConfig) -> bool:
    """True inside a data-parallel group, whose size must be
    ``hc.n_devices``; ``n_devices > 1`` outside a group raises."""
    if mesh.is_active():
        world = mesh.world_size()
        if hc.n_devices != world:
            raise ValueError(f"n_devices={hc.n_devices}, but the process "
                             f"group has {world} ranks")
        return True
    if hc.n_devices > 1:
        raise ValueError(f"n_devices={hc.n_devices} needs a data-parallel "
                         f"group: start the ranks with dist.launch (the "
                         f"CLIs' --devices)")
    return False


def _logger(path: str) -> MetricsLogger:
    """The JSONL log at ``path`` on rank 0, a silent one elsewhere."""
    return MetricsLogger(path) if mesh.rank() == 0 else MetricsLogger(
        None, echo=False)


class GanHarness:
    """``th train.lua``: G and D trained on ``dataset`` on ``device``."""

    def __init__(self, hc: HarnessConfig, gc: gan.GanConfig,
                 dataset: ImageDataset, device: torch.device,
                 logger: Optional[MetricsLogger] = None):
        self.hc = hc
        self.dp = data_parallel(hc)
        axis = mesh.DATA_AXIS if self.dp else None
        self.rank0 = mesh.rank() == 0
        self.gc = dataclasses.replace(
            gc, noise_dim=hc.noise_dim, axis_name=axis,
            acc_window=_acc_window(hc.n_epoch, gc.batch_size))
        self.dataset = dataset
        self.device = device
        self.logger = logger or _logger(
            os.path.join(hc.save_dir, "train_metrics.jsonl"))
        g = models.G_REGISTRY[hc.g_model](hc.image_shape, hc.noise_dim,
                                          axis_name=axis)
        d = models.D_REGISTRY[hc.d_model](hc.image_shape, axis_name=axis)
        init = torch.Generator().manual_seed(hc.seed)  # same on any device
        reset_parameters(g, init)
        reset_parameters(d, init)
        self.state = gan.init_state(g.to(device), d.to(device), self.gc)
        self._maybe_pickup_pretrained_g()
        if self.dp:
            mesh.replicate(self.state)
            self.epoch_fn = dp.make_dp_train_epoch(
                self.state.g, self.state.d, self.gc)
        else:
            self.epoch_fn = gan.make_train_epoch(self.state.g, self.state.d,
                                                 self.gc)
        # V is inference-only here: it rates the samples in visualize
        self.v = None
        self._load_v()
        # fixed visualization noise
        self.vis_noise = gan.uniform_noise(
            torch.Generator().manual_seed(hc.seed + 1), 100, hc.noise_dim,
            device)
        self.plot_data = []
        self._viz_corpus = None
        self._nn_baseline = None
        self.collapse = CollapseDetector() if hc.collapse_detect else None
        self.logger.log("setup", g_params=_count(self.state.g),
                        d_params=_count(self.state.d),
                        acc_window=self.gc.acc_window,
                        n_devices=hc.n_devices, device=str(device))

    # -- checkpoints ---------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(self.hc.save_dir, ckpt.adversarial_filename())

    def _maybe_pickup_pretrained_g(self) -> None:
        """If a pretrained decoder of this shape and noise size is in the
        save directory (by filename), G starts from it."""
        h, w, c = self.hc.image_shape
        path = os.path.join(self.hc.save_dir, ckpt.g_pretrained_filename(
            c, h, w, self.hc.noise_dim))
        if not os.path.exists(path):
            return
        meta = load_variables(self.state.g, path)
        self.logger.log("pretrained_g_loaded", path=path,
                        epoch=meta.get("epoch"))

    def _load_v(self) -> None:
        """V from ``v_<C>x<H>x<W>.ckpt`` in the save directory, if there."""
        h, w, c = self.hc.image_shape
        path = os.path.join(self.hc.save_dir, ckpt.v_filename(c, h, w))
        if not os.path.exists(path):
            self.logger.log("v_missing", path=path)
            return
        v = models.V_REGISTRY[self.hc.v_model](self.hc.image_shape)
        self.v = v.to(self.device).eval()
        load_variables(self.v, path)
        self.logger.log("v_loaded", path=path)

    def save(self, path: Optional[str] = None) -> None:
        """Writes the checkpoint (rank 0 only: the state is replicated)."""
        if not self.rank0:
            return
        norm = 0.5 if self.hc.normalize else None
        meta = {"epoch": self.state.epoch,
                "plot_data": self.plot_data,
                "normalize_mean": norm, "normalize_std": norm,
                "config": dataclasses.asdict(self.hc),
                # a torch.dtype is no JSON value: catgen leaves it out too
                "gan_config": {k: v for k, v in
                               dataclasses.asdict(self.gc).items()
                               if k != "compute_dtype"}}
        path = path or self._ckpt_path()
        ckpt.save(path, train_state_to_leaves(self.state), meta)
        self.logger.log("checkpoint_saved", path=path, epoch=self.state.epoch)

    def resume(self, path: Optional[str] = None,
               rebuild_optstate: bool = False) -> None:
        """Restores the train state from a catgen-format checkpoint. The
        gate's leaves load leniently (a checkpoint of another
        ``acc_window`` re-initializes the window); with
        ``rebuild_optstate`` the optimizer states are rebuilt too."""
        path = path or self._ckpt_path()
        lenient = ("acc_buffer", "acc_count", "acc_index")
        if rebuild_optstate:
            lenient += ("g_opt", "d_opt")
        leaves, meta = ckpt.load_like(path, train_state_to_leaves(self.state),
                                      lenient)
        train_state_from_leaves(self.state, leaves)
        self.plot_data = list(meta.get("plot_data", []))
        if rebuild_optstate:
            d_optim, g_optim = self.gc.make_optimizers()
            self.state.g_opt = g_optim.init(gan.params_of(self.state.g))
            self.state.d_opt = d_optim.init(gan.params_of(self.state.d))
        if meta.get("_reinitialized"):
            self.logger.log("resume_reinit", leaves=meta["_reinitialized"])
        if self.dp:
            mesh.replicate(self.state)
        self.logger.log("resumed", path=path, epoch=self.state.epoch)

    # -- epoch loop ----------------------------------------------------

    def _draws(self) -> Draws:
        """The epoch's draws, seeded by (seed, epoch) and the rank
        (``mesh.rank_seed``): a resumed run draws what the uninterrupted
        run would have."""
        return Draws(mesh.rank_generator(
            self.hc.seed * 1_000_003 + self.state.epoch, self.device))

    def run_epoch(self) -> dict:
        t0 = time.time()
        world = mesh.world_size(self.gc.axis_name)
        half = self.gc.batch_size // 2
        batches = self.dataset.epoch_batches(
            self.hc.n_epoch, half * world, self.gc.d_iterations,
            shard=(mesh.rank(), world) if self.dp else None)
        m = self.epoch_fn(self.state, batches, self._draws())
        # one device-to-host fetch for every epoch scalar; the clock stops
        # after it
        loss_d, loss_g, acc_d, trained, tp, tn, fp, fn = torch.stack([
            m.loss_d.mean(), m.loss_g.mean(), m.acc_d.mean(),
            m.d_trained.mean(), *(x.sum().float() for x in
                                  (m.tp_real, m.tn_fake, m.fp, m.fn))
        ]).tolist()
        dt = time.time() - t0
        n_seen = batches.shape[0] * batches.shape[1] * world
        summary = {
            "epoch": self.state.epoch - 1,
            "loss_d": loss_d,
            "loss_g": loss_g,
            "acc_d": acc_d,
            "d_trained_frac": trained,
            "sec": round(dt, 3),
            "ms_per_sample": round(1000 * dt / max(n_seen, 1), 4),
            "imgs_per_sec": round(n_seen / dt, 1),
        }
        self.logger.log("epoch", **summary)
        if self.rank0:
            print(confusion_summary(int(tp), int(tn), int(fp), int(fn)))
        if self.collapse is not None:
            self.collapse.observe_epoch(summary["epoch"], summary["acc_d"],
                                        summary["loss_g"])
        return summary

    def _to_rgb(self, x: torch.Tensor) -> torch.Tensor:
        if self.hc.normalize:
            x = colorlib.denormalize(x)
        return colorlib.colorspace_to_rgb(x, self.hc.colorspace)

    def visualize(self) -> dict:
        """The per-epoch artifacts: 100 fixed-noise samples, the D-ranked
        best and worst 50, 16 reals, D's scores of a diagonal pattern and
        of a real image, the samples' mean nearest-neighbour distance to a
        fixed slice of the corpus (over the slice's own, the
        ``nn_l2_ratio``) and, with a V, V's mean p(real) over all samples
        and over D's best and worst 50 (``v_rating_*``, also appended to
        ``plot_data``). The collapse detector, if on, observes the
        probes and the samples' statistics; every ``weights_vis_freq``
        epochs D's activations on the first sample are written as grids
        under ``activations/epoch_<N>``."""
        epoch = self.state.epoch
        if self._viz_corpus is None:
            k = min(512, len(self.dataset))
            self._viz_corpus = self._to_rgb(self.dataset.load_images(0, k))
            if k >= 2:
                self._nn_baseline = float(self_nn_mean(
                    self._viz_corpus, self.dataset.family_ids(0, k)))
        reals = self.dataset.load_random_images(16)
        imgs = gan.generate(self.state.g, self.vis_noise)
        order = torch.argsort(-gan.discriminate(self.state.d, imgs),
                              stable=True)
        h, w = reals.shape[1], reals.shape[2]
        idx = torch.arange(h, device=reals.device)[:, None] + torch.arange(
            w, device=reals.device)[None, :]
        pattern = ((idx % 4) < 2).to(imgs.dtype)[..., None].expand(
            reals.shape[1:])
        probes = gan.discriminate(self.state.d,
                                  torch.stack([pattern, reals[0]]))
        with torch.inference_mode():
            rgb = colorlib.colorspace_to_rgb(imgs, self.hc.colorspace)
            nn_l2 = nn_l2_mean(rgb, self._viz_corpus)
            rgb_reals = self._to_rgb(reals)
        v3 = None
        if self.v is not None:
            p = v_trainer.v_scores(self.v, torch.cat(
                [imgs, imgs[order[:50]], imgs[order[-50:]]]))
            n = imgs.shape[0]
            v3 = torch.stack([p[:n].mean(), p[n:n + 50].mean(),
                              p[n + 50:].mean()]).tolist()
        rgb, order, probes, rgb_reals = (
            t.cpu().numpy() for t in (rgb, order, probes, rgb_reals))
        if not np.isfinite(rgb).all():
            self.logger.log("nan_detected", epoch=epoch)
        base = self.hc.save_dir
        name = f"epoch_{epoch:06d}.png"
        if self.rank0:
            save_grid(os.path.join(base, "images", name), rgb, epoch=epoch)
            save_grid(os.path.join(base, "images_good", name),
                      rgb[order[:50]], epoch=epoch)
            save_grid(os.path.join(base, "images_bad", name),
                      rgb[order[-50:]], epoch=epoch)
            save_grid(os.path.join(base, "images_real", name), rgb_reals,
                      epoch=epoch)
        fields = {"epoch": epoch,
                  "d_probe_pattern": float(probes[0]),
                  "d_probe_real": float(probes[1]),
                  "sample_sat": sat_fraction(rgb),
                  "sample_std": per_pixel_std(rgb)}
        if self._nn_baseline:
            fields["nn_l2"] = float(nn_l2)
            fields["nn_l2_ratio"] = fields["nn_l2"] / self._nn_baseline
        if v3 is not None:
            fields["v_rating_all"], fields["v_rating_good"], \
                fields["v_rating_bad"] = v3
            self.plot_data.append([epoch, *v3])
        self.logger.log("viz", **fields)
        if self.collapse is not None:
            self.collapse.observe_viz(epoch, fields["d_probe_pattern"],
                                      fields["d_probe_real"],
                                      fields["sample_sat"],
                                      fields["sample_std"],
                                      fields.get("nn_l2_ratio"))
        if (self.rank0 and self.hc.weights_vis_freq
                and epoch % self.hc.weights_vis_freq == 0):
            save_activation_grids(self.state.d, imgs[:1], os.path.join(
                base, "activations", f"epoch_{epoch:06d}"))
        return fields

    def _profiled_epoch(self, profile_dir: str) -> None:
        """One epoch under ``torch.profiler`` (host and, on a card, CUDA
        activities), its trace written as Chrome JSON into
        ``profile_dir``."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        epoch = self.state.epoch
        with profile(activities=activities) as prof:
            self.run_epoch()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"epoch_{epoch:06d}.trace.json")
        prof.export_chrome_trace(path)
        print(f"[profile] trace written to {path}")

    def train(self, epochs: Optional[int] = None,
              profile_dir: Optional[str] = None) -> str:
        """The reference's epoch loop: visualize every ``vis_freq`` epochs
        (and before the first), train, save every ``save_freq`` epochs and
        at the end. Returns "completed", or "collapsed" when the collapse
        detector fired (checked before each epoch and after the last).

        ``profile_dir``: trace the second epoch (the first with one
        epoch) with ``_profiled_epoch``; it counts against ``epochs`` and
        keeps the save and visualization cadence, as catgen's does."""
        epochs = epochs if epochs is not None else self.hc.epochs
        profile_at = 1 if (epochs is None or epochs > 1) else 0
        done = 0
        while epochs is None or done < epochs:
            if done == 0 or self.state.epoch % self.hc.vis_freq == 0:
                self.visualize()
            if self._collapsed():
                return self._abort_collapsed()
            if profile_dir and done == profile_at and self.rank0:
                self._profiled_epoch(profile_dir)
            else:
                self.run_epoch()
            done += 1
            if self.state.epoch % self.hc.save_freq == 0:
                self.save()
        # the loop checks the verdict only at the top of an iteration, and
        # the final state's samples are not yet observed: check both before
        # the final save writes a possibly degenerate state
        if self.collapse is not None and done > 0:
            if not self._collapsed():
                self.visualize()
            if self._collapsed():
                return self._abort_collapsed()
        # final save, unless the cadence save just wrote this state (a
        # duplicate would rotate the real previous snapshot out of .old)
        if done == 0 or self.state.epoch % self.hc.save_freq != 0:
            self.save()
        return "completed"

    def _collapsed(self) -> bool:
        """Whether the collapse detector has fired: rank 0's verdict,
        broadcast, so that every rank stops at the same epoch."""
        fired = self.collapse is not None and bool(self.collapse.verdict)
        if self.dp and self.collapse is not None:
            flag = torch.tensor([float(fired)], device=self.device)
            mesh.broadcast_([flag])
            fired = bool(flag.item())
        return fired

    def _abort_collapsed(self) -> str:
        """Stops a collapsed run: writes the detector's report, with
        ``aborted_at_epoch``, to ``collapse.json`` and the state to
        ``adversarial_collapsed.ckpt``. ``adversarial.ckpt`` keeps the last
        healthy snapshot, from which a run can resume past the collapse.
        Only rank 0 writes."""
        if not self.rank0:
            return "collapsed"
        report = self.collapse.report()
        report["aborted_at_epoch"] = self.state.epoch
        path = os.path.join(self.hc.save_dir, "collapse.json")
        os.makedirs(self.hc.save_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
        self.logger.log("collapse_detected", reason=report["reason"],
                        fired_epoch=report["fired_epoch"])
        print(f"[collapse] {report['reason']} fired at epoch "
              f"{report['fired_epoch']}: stopping (verdict in {path})")
        self.save(os.path.join(self.hc.save_dir,
                               "adversarial_collapsed.ckpt"))
        return "collapsed"


def _count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def load_variables(module: torch.nn.Module, path: str) -> dict:
    """Loads a catgen ``{"params", "state"}`` checkpoint (V, a pretrained
    G) into ``module`` in place; returns its metadata."""
    leaves, meta = ckpt.load_like(path, variables_to_leaves(module))
    variables_from_leaves(module, leaves)
    return meta


def save_variables(module: torch.nn.Module, path: str, meta: dict) -> None:
    """Writes ``module``'s weights as a catgen ``{"params", "state"}``
    checkpoint."""
    ckpt.save(path, variables_to_leaves(module), meta)


class VHarness:
    """``th train_v.lua``: V trained on ``dataset``'s reals against the
    synthetic fakes, on ``device``, with catgen's overlay bank for
    ``hc.seed`` (``OVERLAY_BANK``), built on the host at start;
    ``bank_seconds`` is how long that took."""

    def __init__(self, hc: HarnessConfig, vc: v_trainer.VConfig,
                 dataset: ImageDataset, device: torch.device,
                 logger: Optional[MetricsLogger] = None):
        self.hc = hc
        self.dp = data_parallel(hc)
        axis = mesh.DATA_AXIS if self.dp else None
        self.rank0 = mesh.rank() == 0
        self.vc = vc = dataclasses.replace(vc, axis_name=axis)
        self.dataset = dataset
        self.device = device
        self.logger = logger or _logger(
            os.path.join(hc.save_dir, "train_v_metrics.jsonl"))
        v = models.V_REGISTRY[hc.v_model](hc.image_shape, axis_name=axis)
        reset_parameters(v, torch.Generator().manual_seed(hc.seed))
        self.state = v_trainer.init_state(v.to(device), vc)
        if self.dp:
            mesh.replicate(self.state)
        h, w, _ = hc.image_shape
        t0 = time.time()
        bank = synthetic.build_overlay_bank(h, w, seed=hc.seed,
                                            **OVERLAY_BANK)
        self.bank_seconds = time.time() - t0
        self.bank = torch.from_numpy(bank).to(device)
        make_epoch = (dp.make_dp_v_epoch if self.dp
                      else v_trainer.make_train_epoch)
        self.epoch_fn = make_epoch(self.state.v, vc, self.bank,
                                   hc.image_shape)
        self.factory = synthetic.SyntheticImageFactory(
            self.bank, hc.image_shape, seed=hc.seed)
        self._np = np.random.RandomState(hc.seed)
        # each epoch's host choices (branches, sub_branches, submix)
        self.choices = []
        self.logger.log("setup", v_params=_count(self.state.v),
                        bank_seconds=round(self.bank_seconds, 3),
                        device=str(device))

    def _ckpt_path(self) -> str:
        h, w, c = self.hc.image_shape
        return os.path.join(self.hc.save_dir, ckpt.v_filename(c, h, w))

    def save(self) -> None:
        if not self.rank0:          # the state is replicated
            return
        save_variables(self.state.v, self._ckpt_path(),
                       {"epoch": self.state.epoch})
        self.logger.log("checkpoint_saved", path=self._ckpt_path(),
                        epoch=self.state.epoch)

    def run_epoch(self) -> dict:
        """One epoch: 5 real half-batches per step (the V batch's reals and
        4 generator feeds) in one copy, the host's generator choices in
        catgen's order, the batches in turn, one metrics fetch. Under data
        parallelism the half-batches are global, each rank keeps its
        share of each, the host's choices are every rank's, and the
        device draws are the rank's own."""
        t0 = time.time()
        half = self.vc.batch_size // 2
        nb = max(self.hc.n_epoch // self.vc.batch_size, 1)
        raw = rank_rows(self.dataset.sample_uint8(
            nb * 5 * half * mesh.world_size()), (nb, 5), mesh.rank(),
            mesh.world_size())
        staged = self.dataset.postprocess(raw.reshape((-1,) + raw.shape[3:]))
        staged = staged.reshape((nb, 5, half) + tuple(staged.shape[1:]))
        reals, gen_reals = staged[:, 0], staged[:, 1:]
        branches = self._np.randint(0, 4, nb)
        sub_branches = self._np.randint(0, 4, nb)
        submix = self._np.rand(nb) < 0.33
        gen = mesh.rank_generator(int(self._np.randint(2 ** 31)),
                                  self.device)
        self.choices.append((branches, sub_branches, submix))
        m = self.epoch_fn(self.state, reals, gen_reals, branches,
                          sub_branches, submix, Draws(gen))
        loss, acc, tp, tn, fp, fn = torch.stack([
            m.loss.mean(), m.acc.mean(),
            *(x.sum().float() for x in (m.tp_real, m.tn_fake, m.fp, m.fn))
        ]).tolist()
        dt = time.time() - t0
        summary = {"epoch": self.state.epoch - 1, "loss": loss, "acc": acc,
                   "sec": round(dt, 3)}
        self.logger.log("epoch", **summary)
        if self.rank0:
            print(confusion_summary(int(tp), int(tn), int(fp), int(fn)))
        return summary

    def visualize(self) -> dict:
        """V judges 50 reals and 50 synthetic images; the grids of those it
        calls real and fake (split at p(real) = 0.5), and a warning when
        the images leave [0, 1]."""
        epoch = self.state.epoch

        def sample_reals(n):
            return self.dataset.postprocess(self.dataset.sample_uint8(n))

        reals = sample_reals(50)
        imgs = torch.cat([reals, self.factory(50, sample_reals)])
        lo, hi = torch.stack([imgs.min(), imgs.max()]).tolist()
        if lo < -0.01 or hi > 1.01:
            self.logger.log("range_warning", epoch=epoch, vmin=lo, vmax=hi)
        scores = v_trainer.v_scores(self.state.v, imgs).cpu().numpy()
        with torch.inference_mode():
            rgb = colorlib.colorspace_to_rgb(
                imgs, self.hc.colorspace).cpu().numpy()
        base = self.hc.save_dir
        name = f"epoch_{epoch:06d}.png"
        good, bad = rgb[scores > 0.5], rgb[scores <= 0.5]
        if len(good) and self.rank0:
            save_grid(os.path.join(base, "v_judged_real", name), good,
                      epoch=epoch)
        if len(bad) and self.rank0:
            save_grid(os.path.join(base, "v_judged_fake", name), bad,
                      epoch=epoch)
        fields = {"epoch": epoch,
                  "judged_real": int((scores > 0.5).sum()),
                  "judged_fake": int((scores <= 0.5).sum()),
                  "mean_score_reals": float(scores[:50].mean()),
                  "mean_score_fakes": float(scores[50:].mean())}
        self.logger.log("viz", **fields)
        return fields

    def train(self, epochs: int, save_freq: int = 10) -> None:
        """Train and visualize each epoch, save every ``save_freq`` epochs
        and at the end (as train_v.lua, even just after a cadence save)."""
        for _ in range(epochs):
            self.run_epoch()
            self.visualize()
            if self.state.epoch % save_freq == 0:
                self.save()
        self.save()


class PretrainHarness:
    """``th pretrain_g.lua``: the 32px G autoencoder trained on
    ``dataset`` on ``device``; saves the decoder as a standalone G."""

    def __init__(self, hc: HarnessConfig, pc: pretrainer.PretrainConfig,
                 dataset: ImageDataset, device: torch.device,
                 logger: Optional[MetricsLogger] = None):
        self.hc = hc
        self.dp = data_parallel(hc)
        axis = mesh.DATA_AXIS if self.dp else None
        self.rank0 = mesh.rank() == 0
        self.pc = dataclasses.replace(pc, noise_dim=hc.noise_dim,
                                      axis_name=axis)
        self.dataset = dataset
        self.device = device
        self.logger = logger or _logger(
            os.path.join(hc.save_dir, "pretrain_metrics.jsonl"))
        ae = models.create_G_autoencoder(hc.image_shape, hc.noise_dim,
                                         axis_name=axis)
        reset_parameters(ae, torch.Generator().manual_seed(hc.seed))
        self.state = pretrainer.init_state(ae.to(device), self.pc)
        if self.dp:
            mesh.replicate(self.state)
        make_epoch = (dp.make_dp_ae_epoch if self.dp
                      else pretrainer.make_train_epoch)
        self.epoch_fn = make_epoch(self.state.ae, self.pc)
        self.logger.log("setup", ae_params=_count(self.state.ae),
                        device=str(device))

    def _ckpt_path(self) -> str:
        h, w, c = self.hc.image_shape
        return os.path.join(self.hc.save_dir, ckpt.g_pretrained_filename(
            c, h, w, self.hc.noise_dim))

    def save(self) -> None:
        if not self.rank0:          # the state is replicated
            return
        save_variables(pretrainer.extract_decoder(self.state.ae),
                       self._ckpt_path(), {"epoch": self.state.epoch})
        self.logger.log("checkpoint_saved", path=self._ckpt_path(),
                        epoch=self.state.epoch)

    def run_epoch(self) -> dict:
        """The step over max(N_epoch / batch, 1) batches of random reals,
        staged in one copy; one metrics fetch. Under data parallelism the
        batches are global and each rank keeps its share of each."""
        t0 = time.time()
        nb = max(self.hc.n_epoch // self.pc.batch_size, 1)
        raw = rank_rows(self.dataset.sample_uint8(
            nb * self.pc.batch_size * mesh.world_size()), (nb,),
            mesh.rank(), mesh.world_size())
        imgs = self.dataset.postprocess(raw.reshape((-1,) + raw.shape[2:]))
        batches = imgs.reshape((nb, self.pc.batch_size)
                               + tuple(imgs.shape[1:]))
        mse = float(self.epoch_fn(self.state, batches).mean())
        dt = time.time() - t0
        summary = {"epoch": self.state.epoch - 1, "mse": mse,
                   "sec": round(dt, 3)}
        self.logger.log("epoch", **summary)
        return summary

    def visualize(self) -> None:
        """16 random reals beside their reconstructions, 8 to a row."""
        epoch = self.state.epoch
        originals = self.dataset.load_random_images(16)
        recon = pretrainer.reconstruct(self.state.ae, originals)
        pairs = torch.stack([originals, recon], dim=1).reshape(
            (-1,) + tuple(originals.shape[1:]))
        with torch.inference_mode():
            rgb = colorlib.colorspace_to_rgb(pairs, self.hc.colorspace)
        if not self.rank0:
            return
        save_grid(os.path.join(self.hc.save_dir, "reconstructions",
                               f"epoch_{epoch:06d}.png"),
                  rgb.cpu().numpy(), nrow=8, epoch=epoch)

    def train(self, epochs: int, save_freq: int = 1) -> None:
        """Train and visualize each epoch, save every ``save_freq`` epochs,
        and once more at the end unless the last epoch was just saved."""
        saved_at = None
        for _ in range(epochs):
            self.run_epoch()
            self.visualize()
            if self.state.epoch % save_freq == 0:
                self.save()
                saved_at = self.state.epoch
        if epochs > 0 and saved_at != self.state.epoch:
            self.save()

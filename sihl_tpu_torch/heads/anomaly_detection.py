"""EfficientAD anomaly detection head (counterpart of
``sihl_tpu/heads/anomaly_detection.py``): the frozen backbone is the
teacher, a student (two outputs a channel) and a conv autoencoder are
trained against it; the anomaly map is the normalised student-teacher
(local) plus student-autoencoder (global) distance.

Its state, buffers serialised with the model, is the JAX head's:

* the calibration: the thresholds, the quantiles ``q_*`` and the teacher
  features' mean and standard deviation, (1, C, 1, 1) here;
* two **reservoirs**, ring buffers into which each training step writes an
  even subsample of the channel-mean distance maps, in place on the
  device, with their position and fill (int32);
* :meth:`on_validation_start` computes the q0.9 / q0.995 calibration
  quantiles from the reservoirs on the host with ``numpy.quantile``, as the
  JAX head does;
* the teacher statistics come from the Welford pretraining protocol
  (``pretrain_init`` / ``pretrain_step`` / ``pretrain_end``) that
  ``Trainer.pretrain`` drives.

The bottleneck's ``Linear`` layers take and give the (h, w, c) order of the
JAX package's NHWC maps, as the autoencoding head's do.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.layers.convblocks import ConvNormAct, SequentialConvBlocks, default_generator, make_conv
from sihl_tpu_torch.layers.mlp import Linear
from sihl_tpu_torch.layers.scalers import SimpleDownscaler, SimpleUpscaler
from sihl_tpu_torch.ops.image import interpolate
from sihl_tpu_torch.ops.relu import relu
from sihl_tpu_torch.policy import resolve_device, upcast
from sihl_tpu_torch.training import metrics as M
from sihl_tpu_torch.utils.welford import welford_compute, welford_init, welford_update


def hard_mined(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` largest values of each row of (B, N), whose mean is the
    hard-mined loss: the values at or above the row's quantile p are its
    top (1 - p) share, and ``torch.topk`` finds them without the full sort
    a quantile needs (``lax.top_k`` in the JAX head)."""
    return torch.topk(flat, k, dim=1, sorted=False).values


class AnomalyDetection(Head):
    """https://arxiv.org/abs/2303.14535 (EfficientAD)."""

    def __init__(
        self,
        in_channels: List[int],
        level: int = 2,
        num_channels: int = 256,
        num_layers: int = 1,
        autoencoder_channels: int = 64,
        autoencoder_top_level: int = 5,
        reservoir_size: int = 65536,
        samples_per_step: int = 1024,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if num_channels <= 0 or num_layers <= 0:
            raise ValueError(f"num_channels, num_layers must be > 0, got {num_channels}, {num_layers}")
        if not len(in_channels) > level > 0:
            raise ValueError(f"level {level} is not among the {len(in_channels) - 1} levels")
        generator = default_generator(generator)
        init = dict(generator=generator, device=device)
        self.level = level
        self.num_channels = num_channels
        self.ae_channels = autoencoder_channels
        self.p_hard = 0.999
        self.autoencoder_top_level = autoencoder_top_level
        self.out_channels = in_channels[level]
        self.reservoir_size = reservoir_size
        self.samples_per_step = samples_per_step

        nc = num_channels
        self.student_in = ConvNormAct(in_channels[0], nc, **init)
        self.student_down = SequentialConvBlocks(nc, nc, level, conv_block=SimpleDownscaler, **init)
        self.student_blocks = SequentialConvBlocks(nc, nc, num_layers, **init)
        self.student_out = make_conv(nc, self.out_channels * 2, 3, **init)

        ac = self.ae_channels
        self.ae_in = ConvNormAct(in_channels[0], ac, **init)
        self.ae_down = SequentialConvBlocks(ac, ac, autoencoder_top_level, conv_block=SimpleDownscaler, **init)
        size = self.ae_size = 8
        self.ae_bottleneck_in = Linear(size * size * ac, ac, **init)
        self.ae_bottleneck_out = Linear(ac, size * size * ac, **init)
        self.ae_up = SequentialConvBlocks(ac, ac, autoencoder_top_level - level, conv_block=SimpleUpscaler, **init)
        self.ae_blocks = SequentialConvBlocks(ac, ac, num_layers, **init)
        self.ae_out = make_conv(ac, self.out_channels, 3, **init)
        self.hard_mined = hard_mined

        device = resolve_device(device)

        def scalar(value):
            return torch.tensor(value, dtype=torch.float32, device=device)

        c = self.out_channels
        self.register_buffer("local_thresh", scalar(0.05))
        self.register_buffer("global_thresh", scalar(0.05))
        self.register_buffer("features_mean", torch.zeros(1, c, 1, 1, device=device))
        self.register_buffer("feature_std", torch.ones(1, c, 1, 1, device=device))
        self.register_buffer("q_st_start", scalar(0.0))
        self.register_buffer("q_st_end", scalar(0.1))
        self.register_buffer("q_ae_start", scalar(0.0))
        self.register_buffer("q_ae_end", scalar(0.1))
        self.register_buffer("st_reservoir", torch.zeros(reservoir_size, device=device))
        self.register_buffer("stae_reservoir", torch.zeros(reservoir_size, device=device))
        self.register_buffer("reservoir_pos", torch.zeros((), dtype=torch.int32, device=device))
        self.register_buffer("reservoir_filled", torch.zeros((), dtype=torch.int32, device=device))
        self.output_shapes = {"anomaly_maps": ("batch_size", "height", "width")}

    # -- submodels ---------------------------------------------------------
    def _student(self, image: torch.Tensor) -> torch.Tensor:
        return self.student_out(self.student_blocks(self.student_down(self.student_in(image))))

    def _autoencoder(self, image: torch.Tensor) -> torch.Tensor:
        x = self.ae_down(self.ae_in(image))
        b, c, h, w = x.shape
        z = interpolate(x, size=(self.ae_size, self.ae_size), mode="bilinear")
        z = self.ae_bottleneck_out(self.ae_bottleneck_in(z.permute(0, 2, 3, 1).reshape(b, -1)))
        z = z.reshape(b, self.ae_size, self.ae_size, c).permute(0, 3, 1, 2)
        z = interpolate(z, size=(h, w), mode="bilinear")
        return self.ae_out(self.ae_blocks(self.ae_up(z)))

    def compute_distances(self, inputs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The squared student-teacher, autoencoder-teacher and
        student-autoencoder distances, (B, C, h, w) each, at the teacher's
        level, in f32 (f64 for an f64 model)."""
        teacher_out = (upcast(inputs[self.level]) - self.features_mean) / self.feature_std
        student_out = upcast(self._student(inputs[0]))
        autoencoder_out = upcast(self._autoencoder(inputs[0]))

        c = self.out_channels
        distance_ae = (autoencoder_out - teacher_out) ** 2
        distance_st = (teacher_out - student_out[:, :c]) ** 2
        distance_stae = (autoencoder_out - student_out[:, c:]) ** 2
        return distance_st, distance_ae, distance_stae

    # -- inference ---------------------------------------------------------
    def _anomaly_maps(self, distance_st, distance_stae, full) -> torch.Tensor:
        local = distance_st.mean(dim=1)
        local = self.local_thresh * ((local - self.q_st_start) / (self.q_st_end - self.q_st_start))
        global_ = distance_stae.mean(dim=1)
        global_ = self.global_thresh * ((global_ - self.q_ae_start) / (self.q_ae_end - self.q_ae_start))
        anomaly = torch.clamp(relu(local) + relu(global_), 0.0, 1.0)
        return interpolate(anomaly[:, None], size=full)[:, 0]

    def forward(self, inputs) -> torch.Tensor:
        """(B, H, W) anomaly maps in [0, 1] at the input's size."""
        distance_st, _, distance_stae = self.compute_distances(inputs)
        return self._anomaly_maps(distance_st, distance_stae, inputs[0].shape[2:])

    # -- training ----------------------------------------------------------
    @torch.no_grad()
    def _update_reservoir(self, distance_st: torch.Tensor, distance_stae: torch.Tensor) -> None:
        """Write an even subsample of the channel-mean distance maps (the
        JAX head's indices ``(arange(k) * max(n // k, 1)) % n`` of the
        flattened (B, h, w) maps) into the ring buffers at their position,
        in place; the fill saturates at the buffers' size."""
        k = self.samples_per_step
        st = distance_st.mean(dim=1).reshape(-1)
        stae = distance_stae.mean(dim=1).reshape(-1)
        n = st.shape[0]
        steps = torch.arange(k, device=st.device)
        idx = (steps * max(n // k, 1)) % n
        pos = (self.reservoir_pos + steps) % self.reservoir_size
        self.st_reservoir[pos] = st[idx].to(self.st_reservoir.dtype)
        self.stae_reservoir[pos] = stae[idx].to(self.stae_reservoir.dtype)
        self.reservoir_pos.copy_((self.reservoir_pos + k) % self.reservoir_size)
        self.reservoir_filled.copy_(torch.clamp(self.reservoir_filled + k, max=self.reservoir_size))

    def _losses(self, distances) -> Tuple[torch.Tensor, Dict]:
        """The hard-mined student-teacher loss at the p = 0.999 quantile of
        each image's distances, plus the two mean distances."""
        distance_st, distance_ae, distance_stae = distances
        flat = distance_st.reshape(distance_st.shape[0], -1)
        k = max(1, int(round(flat.shape[1] * (1.0 - self.p_hard))))
        loss_st = self.hard_mined(flat, k).mean()
        loss_ae = distance_ae.mean()
        loss_stae = distance_stae.mean()
        return loss_st + loss_ae + loss_stae, {
            "loss_student_teacher": loss_st,
            "loss_autoencoder_teacher": loss_ae,
            "loss_student_autoencoder": loss_stae,
        }

    def training_step(self, inputs, targets=None, is_validating: bool = False) -> Tuple[torch.Tensor, Dict]:
        distances = self.compute_distances(inputs)
        if not is_validating:
            self._update_reservoir(distances[0], distances[2])
        return self._losses(distances)

    # -- validation --------------------------------------------------------
    def on_validation_start(self) -> None:
        """Calibrate the normalisation quantiles from the reservoirs, on the
        host (the Trainer calls this before its validation loop); nothing
        while they are empty."""
        filled = int(self.reservoir_filled)
        if filled == 0:
            return
        st = self.st_reservoir[:filled].cpu().numpy()
        stae = self.stae_reservoir[:filled].cpu().numpy()
        for buf, values, q in ((self.q_st_start, st, 0.9), (self.q_st_end, st, 0.995),
                               (self.q_ae_start, stae, 0.9), (self.q_ae_end, stae, 0.995)):
            buf.fill_(float(np.float32(np.quantile(values, q))))

    def metrics_init(self):
        device = self._device()
        return {"loss": M.mean_init(device), "iou": M.segmentation_init(2, device),
                "acc": M.binary_stats_init(device)}

    def validation_step(self, state, inputs, targets=None):
        """The loss as in training, without the reservoir's update; with
        (B, H, W) ``targets`` (anomalous where > 0), the IoU of the maps
        thresholded at 0.5 and the image-level accuracy."""
        distances = self.compute_distances(inputs)
        loss, _ = self._losses(distances)
        new_state = dict(state)
        new_state["loss"] = M.mean_update(state["loss"], loss)
        if targets is not None:
            pred = self._anomaly_maps(distances[0], distances[2], inputs[0].shape[2:])
            pred_bin = (pred > 0.5).to(torch.int32)
            tgt_bin = (targets > 0).to(torch.int32)
            new_state["iou"] = M.segmentation_update(state["iou"], pred_bin, tgt_bin)
            new_state["acc"] = M.binary_stats_update(
                state["acc"], (pred > 0.5).any(dim=2).any(dim=1), (targets > 0).any(dim=2).any(dim=1)
            )
        return new_state, loss, {}

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        seg = M.segmentation_compute(state["iou"])
        acc = M.binary_stats_compute(state["acc"])
        return {
            "loss": float(M.mean_compute(state["loss"])),
            "mean_iou": float(seg["mean_iou"]),
            "accuracy": float(acc["accuracy"]),
        }

    # -- pretraining (the teacher's feature statistics) --------------------
    def pretrain_init(self):
        return welford_init((self.out_channels,), device=self.features_mean.device)

    def pretrain_step(self, state, inputs, targets=None):
        feats = upcast(inputs[self.level]).permute(0, 2, 3, 1).reshape(-1, self.out_channels)
        return welford_update(state, feats)

    @torch.no_grad()
    def pretrain_end(self, state) -> None:
        mean, var = welford_compute(state)
        self.features_mean.copy_(mean.reshape(1, -1, 1, 1))
        self.feature_std.copy_(torch.sqrt(var).reshape(1, -1, 1, 1))

"""The CLIP loss heads, their losses and the EMA memory bank.

Counterpart of ``transformer_clip_eeg_tpu/models/heads.py``.  Every head
holds the two encoders (``eegModel``, ``speechModel``) and the parameters
of the JAX head under the flax names (temperatures, memory bank, latent
projections, the KLD heads' ``mu_eeg_lookup``), so a whole JAX variable
tree carries across.  The ``B x B`` similarity is one ``torch.matmul``, as
the JAX package leaves it to XLA.

flax sizes a head's Dense layers from the embeddings at init; here they are
sized at construction from the encoders' real output shapes
(``output_shape``), and a head whose InfoNCE would multiply embeddings of
two widths raises a ``ValueError`` there, where JAX fails at its init.

Under a data-parallel mesh (``parallel/mesh.py``; ``mesh`` set by
``parallel.attach``) the encoders run on this rank's rows, and the flattened
embeddings and the ids are all-gathered before any of the head's layers and
losses (``parallel/collectives.all_gather_rows``), as GSPMD gathers them
before the JAX head's similarity: every rank then computes the global
batch's losses and applies the same memory-bank update.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transformer_clip_eeg_tpu_torch.ops.layers import (
    Dense,
    Dropout,
    LayerNorm,
    l2_normalize,
    leaky_relu,
)
from transformer_clip_eeg_tpu_torch.parallel.collectives import all_gather_rows


# -- losses ------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch ``F.cross_entropy`` with integer class targets (mean)."""
    return F.cross_entropy(logits, targets)


def soft_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """torch ``F.cross_entropy`` with probability targets (mean)."""
    return -torch.mean(torch.sum(target_probs * F.log_softmax(logits, dim=-1), dim=-1))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch ``F.binary_cross_entropy_with_logits`` (mean), written out as the
    JAX package writes it."""
    return torch.mean(torch.clamp(logits, min=0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def nll_loss(logp: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch ``F.nll_loss`` (mean, integer targets)."""
    return -torch.mean(torch.gather(logp, -1, targets[:, None]))


def simloss(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """NLL over the logits summed across the positives (axis -2)."""
    return nll_loss(x.sum(dim=-2), target)


def log_softmax_mp(x: torch.Tensor) -> torch.Tensor:
    """The log-softmax of the positives' summed probabilities."""
    e = torch.exp(x).sum(dim=-2)
    return torch.log(e) - torch.log(e.sum(dim=-1))[..., None]


def multiple_positives_loss(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return nll_loss(log_softmax_mp(preds), targets)


def log_gauss(x: torch.Tensor, mu, logvar) -> torch.Tensor:
    """Log density of N(mu, exp(logvar)) at ``x``, elementwise."""
    logvar = torch.as_tensor(logvar, dtype=x.dtype, device=x.device)
    return -0.5 * (math.log(2 * math.pi) + logvar + torch.square(x - mu) / torch.exp(logvar))


def kld(p_mu: torch.Tensor, p_logvar: torch.Tensor, q_mu: torch.Tensor, q_logvar
        ) -> torch.Tensor:
    """KL(N(p_mu, exp p_logvar) || N(q_mu, exp q_logvar)), elementwise."""
    q_logvar = torch.as_tensor(q_logvar, dtype=p_mu.dtype, device=p_mu.device)
    return -0.5 * (1 + p_logvar - q_logvar
                   - (torch.square(p_mu - q_mu) + torch.exp(p_logvar)) / torch.exp(q_logvar))


def _symmetric_infonce(
    speech_features: torch.Tensor, eeg_features: torch.Tensor, log_temp: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``logits = speech @ eeg.T * exp(T)``; cross-entropy against
    ``arange(B)`` both ways.  Returns (speech_loss, eeg_loss, logits)."""
    logits = torch.matmul(speech_features, eeg_features.T) * torch.exp(log_temp)
    targets = torch.arange(logits.shape[0], device=logits.device)
    return cross_entropy(logits, targets), cross_entropy(logits.T, targets), logits


def flatten_features(x: torch.Tensor) -> torch.Tensor:
    """``[B, ...]`` → ``[B, -1]`` (torch ``flatten(start_dim=1)``) in float32,
    or float64 for a float64 model (a model with no float32-only kernel, such
    as VLAAI, can be held card against CPU in float64)."""
    return x.reshape(x.shape[0], -1).to(torch.promote_types(x.dtype, torch.float32))


def flatten_maybe_transposed(x: torch.Tensor) -> torch.Tensor:
    """The CLIPSimNoLatentProj quirk: transpose the trailing axes when
    ``shape[1] > shape[2]`` before flattening."""
    if x.dim() == 3 and x.shape[1] > x.shape[2]:
        x = x.transpose(1, 2)
    return flatten_features(x)


def embedding_width(encoder: nn.Module, window_length: int) -> int:
    """The flattened width of ``encoder``'s output for a window, from its
    real output shape (not ``get_output_dim``, which keeps the reference's
    quirks)."""
    return math.prod(encoder.output_shape(window_length))


def _require_width(head: str, what: str, width: int, other: str, other_width: int) -> None:
    if width != other_width:
        raise ValueError(
            f"{head}: the flattened {what} width {width} differs from the {other} "
            f"width {other_width}, so its InfoNCE cannot multiply them; choose "
            f"encoders (or --latent_dim) whose outputs match")


class MemoryBank(nn.Module):
    """EMA memory bank keyed by global segment id: ``memory [bank_size + 1,
    dim]``, U(0, 1) at init."""

    def __init__(self, bank_size: int, dim: int, momentum: float = 0.90):
        super().__init__()
        self.momentum = momentum
        self.register_buffer("memory", torch.empty(bank_size + 1, dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.memory.uniform_(0.0, 1.0, generator=generator)

    def forward(self, idx: torch.Tensor, data: torch.Tensor,
                update: bool = True) -> torch.Tensor:
        """The rows ``idx`` as they were *before* this call, detached; with
        ``update`` the rows become ``m * rows + (1 - m) * data`` (no gradient,
        written in place)."""
        averages = self.memory[idx].detach()
        if update:
            with torch.no_grad():
                self.memory[idx] = (self.momentum * averages
                                    + (1.0 - self.momentum) * data.detach())
        return averages


class ProjectionHead(nn.Module):
    """Dense → LeakyReLU → Dense → Dropout, plus the first Dense's output,
    → LayerNorm."""

    def __init__(self, in_features: int, projection_dim: int = 512, dropout: float = 0.2):
        super().__init__()
        self.projection = Dense(in_features, projection_dim)
        self.fc = Dense(projection_dim, projection_dim)
        self.dropout = Dropout(dropout)
        self.layer_norm = LayerNorm(projection_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        projected = self.projection(x)
        return self.layer_norm(self.dropout(self.fc(leaky_relu(projected))) + projected)


class ProjectionHeadLinear(nn.Module):
    """Dense to twice the width → LeakyReLU → Dense."""

    def __init__(self, in_features: int, projection_dim: int = 512):
        super().__init__()
        self.projection = Dense(in_features, 2 * projection_dim)
        self.last_linear = Dense(2 * projection_dim, projection_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.last_linear(leaky_relu(self.projection(x)))


class _Head(nn.Module):
    """The two encoders, the window and the temperatures a head declares
    (``temperature_eeg`` where JAX declares it, used or not), and the mesh
    whose global batch the head's losses take (None: one process)."""

    def __init__(self, eegModel: nn.Module, speechModel: nn.Module, window_length: int,
                 temperature: Optional[float] = None, temperature_eeg: bool = False):
        super().__init__()
        self.eegModel = eegModel
        self.speechModel = speechModel
        self.window_length = window_length  # read by the challenge regression
        self.mesh = None
        self.init_temperature = temperature
        if temperature is not None:
            self.temperature = nn.Parameter(torch.tensor(float(temperature)))
        if temperature_eeg:
            self.temperature_eeg = nn.Parameter(torch.tensor(float(temperature)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            for name in ("temperature", "temperature_eeg"):
                if hasattr(self, name):
                    getattr(self, name).fill_(self.init_temperature)

    def widths(self) -> Tuple[int, int]:
        """The flattened EEG and speech embedding widths."""
        return (embedding_width(self.eegModel, self.window_length),
                embedding_width(self.speechModel, self.window_length))

    def encode_eeg(self, eeg: torch.Tensor) -> torch.Tensor:
        return self.eegModel(eeg)

    def encode_speech(self, speech: torch.Tensor) -> torch.Tensor:
        return self.speechModel(speech)

    def _features(self, eeg: torch.Tensor, speech: torch.Tensor, transposed: bool = False):
        """Both encoders' flattened outputs; under a mesh every rank's rows,
        gathered in one all-gather."""
        flatten = flatten_maybe_transposed if transposed else flatten_features
        eeg_f, sp_f = flatten(self.eegModel(eeg)), flatten(self.speechModel(speech))
        if self.mesh is None:
            return eeg_f, sp_f
        both = all_gather_rows(torch.cat([eeg_f, sp_f], 1), self.mesh)
        return both.split([eeg_f.shape[1], sp_f.shape[1]], 1)

    def _global_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """The segment ids of the global batch."""
        return ids if self.mesh is None else all_gather_rows(ids, self.mesh)

    def _normalised(self, eeg: torch.Tensor, speech: torch.Tensor, transposed: bool = False):
        eeg_f, sp_f = self._features(eeg, speech, transposed)
        return l2_normalize(eeg_f, 1), l2_normalize(sp_f, 1)

    def _require_equal_widths(self) -> None:
        eeg_w, sp_w = self.widths()
        _require_width(type(self).__name__, "EEG", eeg_w, "speech", sp_w)


class CLIP(_Head):
    """Plain symmetric InfoNCE; returns the loss."""

    def __init__(self, eegModel: nn.Module, speechModel: nn.Module, temperature: float = 1.0,
                 window_length: int = 192):
        super().__init__(eegModel, speechModel, window_length, temperature)
        self._require_equal_widths()

    def forward(self, eeg: torch.Tensor, speech: torch.Tensor, ids: torch.Tensor = None):
        eeg_f, sp_f = self._normalised(eeg, speech)
        s_loss, e_loss, _ = _symmetric_infonce(sp_f, eeg_f, self.temperature)
        return (s_loss + e_loss) / 2.0


class CLIPSim(_Head):
    """InfoNCE on bias-free latent projections of both streams, plus the MSE
    between the memory bank's rows and the projected EEG.  Each projection
    takes its own stream's width, as the JAX Dense infers it (the reference
    sizes the speech one from the EEG width)."""

    def __init__(
        self,
        eegModel: nn.Module,
        speechModel: nn.Module,
        bank_size: int,
        temperature: float = 1.0,
        latent_dim: int = 16,
        window_length: int = 192,
        lambda_clip: float = 1.0,
        lambda_average: float = 1.0,
        momentum_membank: float = 0.90,
    ):
        super().__init__(eegModel, speechModel, window_length, temperature)
        self.lambda_clip, self.lambda_average = lambda_clip, lambda_average
        eeg_w, sp_w = self.widths()
        self.latent_projection_eeg = Dense(eeg_w, latent_dim, bias=False)
        self.latent_projection_speech = Dense(sp_w, latent_dim, bias=False)
        self.eegMemoryBank = MemoryBank(bank_size, latent_dim, momentum_membank)

    def forward(self, eeg: torch.Tensor, speech: torch.Tensor, ids: torch.Tensor,
                update_membank: bool = True):
        eeg_e, sp_e = self._features(eeg, speech)
        eeg_f = l2_normalize(self.latent_projection_eeg(eeg_e), 1)
        sp_f = l2_normalize(self.latent_projection_speech(sp_e), 1)
        averages = l2_normalize(
            self.eegMemoryBank(self._global_ids(ids), eeg_f, update=update_membank), 1)
        s_loss, e_loss, _ = _symmetric_infonce(sp_f, eeg_f, self.temperature)
        loss_ce = (s_loss + e_loss) / 2.0
        avg_loss = torch.mean(torch.square(averages - eeg_f))
        loss_total = self.lambda_clip * loss_ce + self.lambda_average * avg_loss
        return loss_ce, avg_loss, loss_total


class CLIPSimNoLatentProj(_Head):
    """The default architecture: no latent projection, the transpose-if-wider
    flatten, and a second InfoNCE between the memory bank's rows and the
    current EEG features with its own temperature."""

    def __init__(
        self,
        eegModel: nn.Module,
        speechModel: nn.Module,
        bank_size: int,
        latent_dim: int,
        temperature: float = 1.0,
        window_length: int = 192,
        lambda_clip: float = 1.0,
        lambda_average: float = 1.0,
        momentum_membank: float = 0.90,
    ):
        super().__init__(eegModel, speechModel, window_length, temperature,
                         temperature_eeg=True)
        self.lambda_clip, self.lambda_average = lambda_clip, lambda_average
        self._require_equal_widths()
        _require_width(type(self).__name__, "EEG", self.widths()[0], "memory bank's",
                       latent_dim)
        self.eegMemoryBank = MemoryBank(bank_size, latent_dim, momentum_membank)

    def forward(self, eeg: torch.Tensor, speech: torch.Tensor, ids: torch.Tensor,
                update_membank: bool = True):
        """``(loss_ce, avg_loss, loss_total)`` for a batch of windows and their
        global segment ids; the bank's rows ``ids`` are EMA-updated with the
        batch's EEG features when ``update_membank``."""
        eeg_f, sp_f = self._normalised(eeg, speech, transposed=True)
        averages = l2_normalize(
            self.eegMemoryBank(self._global_ids(ids), eeg_f, update=update_membank), 1)
        s_loss, e_loss, _ = _symmetric_infonce(sp_f, eeg_f, self.temperature)
        loss_ce = (s_loss + e_loss) / 2.0
        avg_loss, _, _ = _symmetric_infonce(averages, eeg_f, self.temperature_eeg)
        loss_total = self.lambda_clip * loss_ce + self.lambda_average * avg_loss
        return loss_ce, avg_loss, loss_total


class BaseMatchMismatch(_Head):
    """2-way match-mismatch: soft cross-entropy on (diagonal, superdiagonal)
    logits; returns ``(loss, accuracy)``."""

    def __init__(self, eegModel: nn.Module, speechModel: nn.Module, latent_dim: int = 16,
                 window_length: int = 192, temperature: float = 0.075):
        super().__init__(eegModel, speechModel, window_length, temperature)
        self._require_equal_widths()

    def forward(self, eeg: torch.Tensor, speech: torch.Tensor, ids: torch.Tensor = None):
        eeg_f, sp_f = self._normalised(eeg, speech)
        _, _, logits = _symmetric_infonce(sp_f, eeg_f, self.temperature)
        match = torch.diagonal(logits)
        mismatch = torch.cat([torch.diagonal(logits, offset=1), logits[-2, -1][None]])
        pair_logits = torch.stack([match, mismatch], dim=1)  # [B, 2]
        n = pair_logits.shape[0]
        targets = torch.stack([pair_logits.new_ones(n), pair_logits.new_zeros(n)], dim=1)
        loss = soft_cross_entropy(pair_logits, targets)
        accuracy = torch.mean((torch.argmax(pair_logits, 1) == torch.argmax(targets, 1)).float())
        return loss, accuracy


class CLIPNoContrastiveLearning(_Head):
    """The ablation: BCE on the diagonal (match) against the superdiagonal
    (mismatch) logits; returns the loss three times."""

    def __init__(self, eegModel: nn.Module, speechModel: nn.Module, window_length: int = 192):
        super().__init__(eegModel, speechModel, window_length)
        self._require_equal_widths()

    def forward(self, eeg: torch.Tensor, speech: torch.Tensor, ids: torch.Tensor = None):
        eeg_f, sp_f = self._normalised(eeg, speech, transposed=True)
        logits = torch.matmul(sp_f, eeg_f.T)
        stacked = torch.stack([torch.diagonal(logits)[:-1], torch.diagonal(logits, offset=1)])
        n = logits.shape[0] - 1
        targets = torch.stack([logits.new_ones(n), logits.new_zeros(n)])
        loss = bce_with_logits(stacked, targets)
        return loss, loss, loss


class CLIPSimMultiplePositives(_Head):
    """Multiple positives per speech segment: the EEG side's cross-entropy,
    the speech side's multiple-positives NLL, and ``simloss`` as the second
    loss."""

    def __init__(self, eegModel: nn.Module, speechModel: nn.Module, temperature: float = 1.0,
                 window_length: int = 192, lambda_clip: float = 1.0,
                 lambda_average: float = 1.0):
        super().__init__(eegModel, speechModel, window_length, temperature,
                         temperature_eeg=True)
        self.lambda_clip, self.lambda_average = lambda_clip, lambda_average
        self._require_equal_widths()

    def _logits(self, eeg: torch.Tensor, speech: torch.Tensor):
        eeg_f, sp_f = self._normalised(eeg, speech)
        logits = torch.matmul(sp_f, eeg_f.T) * torch.exp(self.temperature)
        n_speech = logits.shape[0]
        targets = torch.arange(n_speech, device=logits.device)
        eeg_loss = cross_entropy(logits.T, targets.repeat(logits.shape[1] // n_speech))
        return logits.reshape(n_speech, -1, n_speech), targets, eeg_loss

    def forward(self, eeg: torch.Tensor, speech: torch.Tensor, ids: torch.Tensor = None):
        logits_speech, targets, eeg_loss = self._logits(eeg, speech)
        speech_loss = multiple_positives_loss(logits_speech, targets)
        sim_loss = simloss(logits_speech, targets)
        loss_ce = (speech_loss + eeg_loss) / 2.0
        loss_total = self.lambda_clip * loss_ce + self.lambda_average * sim_loss
        return loss_ce, sim_loss, loss_total


class CLIPSimMultiplePositivesAdapted(CLIPSimMultiplePositives):
    """The positives' logits summed per speech segment, then a plain
    cross-entropy; returns ``(loss_ce, loss_ce, lambda_clip * loss_ce)``."""

    def forward(self, eeg: torch.Tensor, speech: torch.Tensor, ids: torch.Tensor = None):
        logits_speech, targets, eeg_loss = self._logits(eeg, speech)
        speech_loss = cross_entropy(logits_speech.sum(dim=1), targets)
        loss_ce = (speech_loss + eeg_loss) / 2.0
        return loss_ce, loss_ce, self.lambda_clip * loss_ce


class _KLDHead(_Head):
    """What the two KLD heads share: ``mu_eeg_lookup`` (one learnable prior
    mean per segment id, drawn N(0, 1)) and the loss from the EEG posterior
    ``(mu, logvar)``: the lookup's log density under N(0, 1), the KL to
    N(lookup row, 0.5^2), and the InfoNCE.  JAX also draws a reparameterised
    sample of the posterior and never uses it; the port draws nothing, so
    the losses do not depend on a random stream.  Returns ``(loss_total,
    loss_ce, mean log_pmu2, mean kld_z2)``."""

    def __init__(self, eegModel, speechModel, number_of_classes: int, lookup_dim: int,
                 temperature: float, window_length: int, lambda_clip: float,
                 lambda_lower_bound: float):
        super().__init__(eegModel, speechModel, window_length, temperature,
                         temperature_eeg=True)
        self.lambda_clip, self.lambda_lower_bound = lambda_clip, lambda_lower_bound
        self.mu_eeg_lookup = nn.Parameter(torch.empty(number_of_classes + 1, lookup_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            self.mu_eeg_lookup.normal_(0.0, 1.0, generator=generator)

    def _losses(self, ids, z_mu, z_logvar, eeg_n, sp_n):
        mu2_eeg = self.mu_eeg_lookup[self._global_ids(ids)]
        log_pmu2 = torch.mean(log_gauss(mu2_eeg, 0.0, 0.0), dim=1)
        kld_z2 = torch.mean(kld(z_mu, z_logvar, mu2_eeg, math.log(0.5 ** 2)), dim=1)
        lower_bound = torch.mean(-log_pmu2 + kld_z2, dim=0)
        s_loss, e_loss, _ = _symmetric_infonce(sp_n, eeg_n, self.temperature)
        loss_ce = (s_loss + e_loss) / 2.0
        loss_total = self.lambda_clip * loss_ce + self.lambda_lower_bound * lower_bound
        return loss_total, loss_ce, torch.mean(log_pmu2), torch.mean(kld_z2)


class CLIPKLDNoLatentProj(_KLDHead):
    """The KLD head on the raw embeddings: the posterior's mean and log
    variance are Dense layers (width ``latent_dimension2``) of the EEG
    embedding, the InfoNCE runs on the embeddings themselves."""

    def __init__(
        self,
        eegModel: nn.Module,
        speechModel: nn.Module,
        latent_dimension: int,
        number_of_classes: int,
        latent_dimension2: int = 64,
        temperature: float = 1.0,
        window_length: int = 192,
        lambda_clip: float = 1.0,
        lambda_lower_bound: float = 1.0,
    ):
        super().__init__(eegModel, speechModel, number_of_classes, latent_dimension2,
                         temperature, window_length, lambda_clip, lambda_lower_bound)
        self.latent_dimension = latent_dimension
        self._require_equal_widths()
        eeg_w = self.widths()[0]
        self.eeg_mu_linear = Dense(eeg_w, latent_dimension2)
        self.eeg_logvar_linear = Dense(eeg_w, latent_dimension2)

    def forward(self, eeg: torch.Tensor, speech: torch.Tensor, ids: torch.Tensor):
        eeg_f, sp_f = self._features(eeg, speech)
        return self._losses(ids, self.eeg_mu_linear(eeg_f), self.eeg_logvar_linear(eeg_f),
                            l2_normalize(eeg_f, 1), l2_normalize(sp_f, 1))


class CLIPKLDWithLatentProj(_KLDHead):
    """The KLD head with projection heads on both streams: the EEG's gives the
    posterior's mean (also the EEG side of the InfoNCE) and log variance, the
    speech's the speech side."""

    def __init__(
        self,
        eegModel: nn.Module,
        speechModel: nn.Module,
        latent_dimension: int,
        number_of_classes: int,
        temperature: float = 1.0,
        window_length: int = 192,
        lambda_clip: float = 1.0,
        lambda_lower_bound: float = 1.0,
        projection_head: str = "linear",
    ):
        super().__init__(eegModel, speechModel, number_of_classes, latent_dimension,
                         temperature, window_length, lambda_clip, lambda_lower_bound)
        proj = ProjectionHead if projection_head == "non-linear" else ProjectionHeadLinear
        eeg_w, sp_w = self.widths()
        self.eeg_logvar_linear = proj(eeg_w, latent_dimension)
        self.eeg_mu_linear = proj(eeg_w, latent_dimension)
        self.speech_latent_projection = proj(sp_w, latent_dimension)

    def forward(self, eeg: torch.Tensor, speech: torch.Tensor, ids: torch.Tensor):
        eeg_f, sp_f = self._features(eeg, speech)
        eeg_mu = self.eeg_mu_linear(eeg_f)
        return self._losses(ids, eeg_mu, self.eeg_logvar_linear(eeg_f),
                            l2_normalize(eeg_mu, 1),
                            l2_normalize(self.speech_latent_projection(sp_f), 1))

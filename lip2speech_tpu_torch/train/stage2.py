"""Stage-2 (vocoder) GAN training on one card (JAX reference:
train/stage2.py).

One `gan_step` runs the generator once, in training mode (dropout 0.1 on
the upsampled units, drawn from the state's generator), and takes two
updates from that one waveform y_hat, as the reference's single y_g_hat:

  D: LSGAN loss of the multi-period and multi-scale discriminators on
     (y, y_hat detached); AdamW on both discriminators together.
  G: mel L1 x lambda_mel (HiFi-GAN log-mel at the loss STFT) + feature
     matching (x 2 inside feature_loss) + LSGAN adversarial loss, against
     the updated discriminators; AdamW on the generator.

Both optimizers are AdamW(0.8, 0.99, eps 1e-8, weight decay 0.01) at the
rate lr * lr_decay ** epoch; `next_epoch` advances the epoch. The first
scale discriminator's spectral-norm vectors u take two power iterations in
the D step (real, then generated) and keep them; the G step's iterations
are used for its sigma and then thrown away, as the JAX step keeps only the
D step's u. f32 throughout; the state is updated in place. No global TF32
flag is set here. On the card the generator's four <=128-channel stages run
the trio kernel under autograd (ops/fused_tail.py: TrioFn), four launches a
step. The entry points run on the card unless the caller passes
device="cpu", and raise without one.

With a mesh of ranks (parallel/mesh.py) the step is data-parallel, as the
JAX mesh step: every rank passes the same (global) batch and takes its rows
(the batch must divide the data axis); the losses are means over equal
shards, so the mean over the data axis of each rank's gradients is the
global batch's, and the discriminators' gradients are averaged (bucketed
all-reduces of the flat gradients) before their update, the generator's
before its own. The logs are averaged too. Each rank draws its own dropout
(seed + data index).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lip2speech_tpu_torch.core.config import PipelineConfig
from lip2speech_tpu_torch.models.layers import init_weights
from lip2speech_tpu_torch.models.vocoder import (
    MelCodeGenerator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_adv_loss,
)
from lip2speech_tpu_torch.ops.dsp import mel_spectrogram_hifigan
from lip2speech_tpu_torch.parallel.collectives import all_reduce_flat
from lip2speech_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, require_ranks, shard_batch
from lip2speech_tpu_torch.pipeline.synthesise import resolve_device

ADAM_EPS = 1e-8          # optax.adamw's default, which the JAX step takes
WEIGHT_DECAY = 0.01


@dataclass
class GanState:
    step: int                          # GAN steps taken
    epoch: int                         # drives the per-epoch rate decay
    generator: MelCodeGenerator
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator       # holds the spectral-norm u buffers
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer    # MPD and MSD together
    rng: torch.Generator               # the generator's dropout, on the state's device
    mesh: Mesh | None = None           # the ranks the state is replicated over

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device


def _adamw(cfg: PipelineConfig, params) -> torch.optim.Optimizer:
    s2 = cfg.stage2
    return torch.optim.AdamW(params, lr=s2.lr, betas=(s2.adam_b1, s2.adam_b2), eps=ADAM_EPS,
                             weight_decay=WEIGHT_DECAY)


def create_gan_state(cfg: PipelineConfig, seed: int | None = None,
                     device: str | torch.device | None = None,
                     state_dicts: dict[str, dict[str, torch.Tensor]] | None = None,
                     mesh: Mesh | None = None) -> GanState:
    """Generator, discriminators, optimizers and dropout generator on
    `device` (None: the card). Weights come from state_dicts ({"generator",
    "mpd", "msd"}, each loaded strict; the MSD's includes its u buffers) or,
    without them, from a torch.Generator seeded with `seed` (default
    cfg.stage2.seed) on the CPU, so a seed gives the same weights on every
    machine. With a mesh of ranks the dropout generator is seeded with seed
    + the rank's data index."""
    dev = resolve_device(device)
    seed = cfg.stage2.seed if seed is None else seed
    modules = {"generator": MelCodeGenerator(cfg.vocoder), "mpd": MultiPeriodDiscriminator(),
               "msd": MultiScaleDiscriminator()}
    init_gen = torch.Generator().manual_seed(seed)
    for name, m in modules.items():
        if state_dicts is None:
            init_weights(m, init_gen)
        else:
            m.load_state_dict(state_dicts[name], strict=True)
        m.to(dev).train()
    g, mpd, msd = modules.values()
    if mesh is not None:
        seed += mesh.data_index
    return GanState(step=0, epoch=0, generator=g, mpd=mpd, msd=msd,
                    gen_opt=_adamw(cfg, g.parameters()),
                    disc_opt=_adamw(cfg, [*mpd.parameters(), *msd.parameters()]),
                    rng=torch.Generator(device=dev).manual_seed(seed), mesh=mesh)


def _mel_of(cfg: PipelineConfig):
    au = cfg.audio

    def mel(wav):
        return mel_spectrogram_hifigan(wav, au.sample_rate, au.loss_n_fft, au.loss_hop_length,
                                       au.loss_win_length, au.num_mels, au.fmin, au.loss_fmax)

    return mel


def _to_device(batch: dict, dev: torch.device) -> dict:
    out = {k: torch.as_tensor(batch[k], device=dev) for k in ("audio", "mel", "spk_emb")}
    out["code"] = torch.as_tensor(batch["code"], device=dev).long()
    return out


def _mean_over_data(mesh: Mesh | None, tensors: list[torch.Tensor]) -> None:
    """Average `tensors` in place over the mesh's data axis."""
    if mesh is not None:
        all_reduce_flat(tensors, mesh.data_group)
        torch._foreach_div_(tensors, float(mesh.shape[DATA_AXIS]))


def _grads(params) -> list[torch.Tensor]:
    """The gradients there are (every rank runs the same graph, so the same
    parameters have none)."""
    return [p.grad for p in params if p.grad is not None]


def make_gan_step(cfg: PipelineConfig, mesh: Mesh | None = None):
    """Returns gan_step(state, batch) -> (state, logs). batch: numpy arrays
    or tensors, audio (B, S), code (B, S/320), mel (B, S/160, 80), spk_emb
    (B, 256); other keys are ignored. logs are 0-d tensors on the state's
    device: loss_disc, loss_gen, loss_mel (the L1 before lambda_mel),
    loss_fm, loss_adv. state is updated in place. With a mesh of ranks every
    rank passes the same (global) batch and takes its rows."""
    require_ranks(mesh)
    s2 = cfg.stage2
    mel_of = _mel_of(cfg)

    def gan_step(state: GanState, batch: dict):
        if mesh is not None:
            batch = shard_batch(mesh, {k: batch[k] for k in ("audio", "mel", "spk_emb", "code")})
        b = _to_device(batch, state.device)
        y = b["audio"]
        rate = s2.lr * s2.lr_decay ** state.epoch
        for m in (state.generator, state.mpd, state.msd):
            m.train()
        with torch.no_grad():
            y_mel = mel_of(y)
        y_hat = state.generator(b["code"], b["mel"], b["spk_emb"], gen=state.rng)

        # D step, on the generated waveform detached
        state.disc_opt.zero_grad(set_to_none=True)
        rs, gs, _, _ = state.mpd(y, y_hat.detach())
        rs2, gs2, _, _ = state.msd(y, y_hat.detach())
        loss_disc = discriminator_loss(rs, gs) + discriminator_loss(rs2, gs2)
        loss_disc.backward()
        _mean_over_data(mesh, _grads([p for g in state.disc_opt.param_groups for p in g["params"]]))
        for group in state.disc_opt.param_groups:
            group["lr"] = rate
        state.disc_opt.step()
        u_after_d = {k: v.clone() for k, v in state.msd.named_buffers()}

        # G step, against the updated discriminators
        state.gen_opt.zero_grad(set_to_none=True)
        loss_mel = (y_mel - mel_of(y_hat)).abs().mean() * s2.lambda_mel
        _, gs_f, fr_f, fg_f = state.mpd(y, y_hat)
        _, gs_s, fr_s, fg_s = state.msd(y, y_hat)
        loss_fm = feature_loss(fr_f, fg_f) + feature_loss(fr_s, fg_s)
        loss_adv = generator_adv_loss(gs_f) + generator_adv_loss(gs_s)
        loss_gen = loss_mel + loss_fm + loss_adv
        gen_params = list(state.generator.parameters())
        loss_gen.backward(inputs=gen_params)
        with torch.no_grad():
            for k, v in state.msd.named_buffers():
                v.copy_(u_after_d[k])
        _mean_over_data(mesh, _grads(gen_params))
        for group in state.gen_opt.param_groups:
            group["lr"] = rate
        state.gen_opt.step()
        state.step += 1
        logs = {"loss_disc": loss_disc, "loss_gen": loss_gen, "loss_mel": loss_mel / s2.lambda_mel,
                "loss_fm": loss_fm, "loss_adv": loss_adv}
        logs = {k: v.detach() for k, v in logs.items()}
        if mesh is not None:
            logs = {k: v.clone() for k, v in logs.items()}
            _mean_over_data(mesh, list(logs.values()))
        return state, logs

    return gan_step


def next_epoch(state: GanState) -> GanState:
    state.epoch += 1
    return state


@torch.no_grad()
def validation_mel_l1(generator: MelCodeGenerator, batch: dict, cfg: PipelineConfig) -> torch.Tensor:
    """Mean |mel(y) - mel(y_hat)| on whole clips, the generator in eval mode
    (no dropout); its mode is restored after."""
    b = _to_device(batch, next(generator.parameters()).device)
    was_training = generator.training
    generator.eval()
    try:
        y_hat = generator(b["code"], b["mel"], b["spk_emb"])
    finally:
        generator.train(was_training)
    mel_of = _mel_of(cfg)
    return (mel_of(b["audio"]) - mel_of(y_hat)).abs().mean()

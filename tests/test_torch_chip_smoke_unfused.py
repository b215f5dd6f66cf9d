"""chip_smoke.py's phases 19a-19d (the paths without a kernel: Swin's
attention-dropout branch, ViT's unfused halves, MedViT-3D, the stabilizers
on unfused blocks), rehearsed on the CPU at a tiny size with one torch
thread.

On the CPU K4's wrapper runs its plain version and the "card" is the CPU,
so the gates must pass the port as it is and reject two mutants: an XLA
attention branch that leaves out the region mask (the branch gate against
K4), and an E-MHSA that pools the wrong tokens (the MedViT gate of the
card's f32 step against the CPU's, the mutant on the "card" side only).
The training and eval helpers run with the CUDA timing and memory calls
stubbed; the launch checks see no launch, as the paths launch none.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_chip_smoke import one_thread  # noqa: F401
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.models import layers
from vsn_tpu_torch.models import medvit3d as mv

SWIN_TINY = dict(IMG_SIZE=[12, 18, 12], PATCH_SHAPE=[2, 2, 2],
                 WINDOW_SIZE=[2, 3, 2], EMBED_DIM=8, DEPTH=[2, 2, 2],
                 HEADS=[1, 2, 4], FP16=False, ATTENTION_DROPOUT=0.2, SEED=0)
VIT_TINY = dict(ARCHITECTURE="ViT", IMG_SIZE=[16, 16, 16], RESHAPE_SIZE=False,
                PATCH_SHAPE=[4, 4, 4], EMBED_DIM=128, DEPTH=2, HEADS=2,
                STOCHASTIC_DEPTH_PROB=0.2, SEED=0)
MEDVIT_TINY = dict(ARCHITECTURE="MedViT", IMG_SIZE=[36, 40, 20],
                   DEPTH=[1, 2, 5, 1], HEADS=8, MLP_RATIO=3, SEED=0)
RECIPE = dict(USE_SAM=True, USE_EMA=True, USE_MIXUP=True, LABEL_SMOOTHING=0.1,
              BATCH_SIZE=2, EFFECTIVE_BATCH_SIZE=4, LR_WARMUP=0, WD_WARMUP=0,
              STEPS=10)
TINY_CASES = {"shifted ids", "padded ids", "no mask", "N=12"}


@pytest.fixture
def on_cpu(monkeypatch):
    """The CUDA timing and memory calls stubbed, models built on the CPU."""
    for name, fn in (("synchronize", lambda *a: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(chip_smoke, "seeded_model", functools.partial(
        chip_smoke.seeded_model, device="cpu"))


def _swin():
    return chip_smoke.seeded_model(load_config(SWIN_TINY), device="cpu").train()


def _x(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_branch_gate_passes_and_fails_without_the_region_mask(monkeypatch):
    calls = chip_smoke.branch_calls(_swin(), _x((2, 12, 18, 12, 1)),
                                    torch.Generator().manual_seed(1))
    assert len(calls) == 6
    counted = []
    monkeypatch.setattr(chip_smoke, "check_counts",
                        lambda counts, per, units, what: counted.append(
                            (per, units)))
    worst = chip_smoke.branch_gate(calls, torch.Generator().manual_seed(2),
                                   TINY_CASES)
    assert worst < 0.1 and counted == [({"attention": 1}, 6)]
    with pytest.raises(AssertionError, match="lacks"):
        chip_smoke.branch_gate(calls, torch.Generator().manual_seed(2))
    monkeypatch.setattr(layers, "region_mask",
                        lambda ids: torch.zeros(ids.shape + ids.shape[-1:]))
    with pytest.raises(AssertionError, match="XLA branch vs K4"):
        chip_smoke.branch_gate(calls, torch.Generator().manual_seed(2),
                               TINY_CASES)


def test_stage_keep_shares_count_each_stages_masks():
    model = _swin()
    draws = model.draw(2, torch.device("cpu"), torch.Generator().manual_seed(0))
    shares = chip_smoke.stage_keep_shares(model, draws)
    assert set(shares) == {0, 1, 2}
    stage1 = torch.cat([d.reshape(-1) for (key, _), d in
                        zip(model.draw_plan(2), draws)
                        if key[1] == "attn" and key[0] < 2])
    assert shares[0] == pytest.approx(stage1.float().mean().item())
    assert all(0.7 < s < 0.9 for s in shares.values())


def test_short_train_path(on_cpu):
    cfg = load_config(dict(SWIN_TINY, FP16=True, **RECIPE))
    batch = chip_smoke.train_batch(cfg, torch.device("cpu"), 5)
    metrics, model = chip_smoke.short_train_path(cfg, batch, {}, "rehearsal",
                                                 "cpu")
    assert len(metrics) == 2 and metrics[0]["loss"] != metrics[1]["loss"]
    stab = load_config(dict(SWIN_TINY, FP16=True, ATTENTION_DROPOUT=0.0,
                            **chip_smoke.UNFUSED_STABILIZERS, **RECIPE))
    plain = lambda: chip_smoke.patched_model_ops(lambda n, k, p: p)
    chip_smoke.short_train_path(stab, batch, {}, "rehearsal", "cpu",
                                plain=plain)


def test_vit_unfused_gate(on_cpu):
    cfg = load_config(dict(VIT_TINY, FP16=True))
    train_cfg = load_config(dict(VIT_TINY, FP16=True, **RECIPE))
    images = np.random.default_rng(0).standard_normal(
        (4, 16, 16, 16, 1)).astype(np.float16)
    batch = chip_smoke.train_batch(train_cfg, torch.device("cpu"), 6)
    rel = chip_smoke.vit_unfused_gate(cfg, train_cfg, images, batch, "cpu")
    assert rel["loss"] < 1e-2 and rel["grad_norm"] < 1e-2


def _medvit_pair(scale=3.0):
    """A tiny MedViT (f32) with its kernels times ``scale`` and statistics
    from a training forward, and a copy: the "card's" and the CPU's."""
    cfg = load_config(dict(MEDVIT_TINY, FP16=False))
    model = chip_smoke.seeded_model(cfg, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim > 1:
                p.mul_(scale)
        model.train()
        model(_x((2, 36, 40, 20, 1), 5), generator=torch.Generator()
              .manual_seed(0))
    twin = build_model(cfg, device="cpu")
    twin.load_state_dict(model.state_dict())
    return cfg, model.eval(), twin


def test_medvit_f32_gate_passes_and_fails_on_the_wrong_tokens(monkeypatch):
    cfg, card, cpu = _medvit_pair()
    x = _x((2, 36, 40, 20, 1), 1)
    labels = torch.eye(cfg.num_classes)[[0, 1]]
    gains = card.draw(2, torch.device("cpu"), torch.Generator().manual_seed(3))
    draws_of = lambda dev: gains
    worst = chip_smoke.medvit_f32_gate(card, cpu, x, labels, draws_of)
    assert set(worst) == {"logits", "loss", "grads", "grad_max", "stats"}
    assert max(worst.values()) < 1e-2
    real = mv.EMHSA.forward
    card_ids = {id(m) for m in card.modules()}

    def wrong_tokens(self, x, masks=(None, None)):
        """E-MHSA with its keys and values pooled from the last m r tokens
        instead of the first (on the "card's" model)."""
        if id(self) not in card_ids or self.sr_ratio == 1:
            return real(self, x, masks)
        b, n, c = x.shape
        m, r = self.reduced(n), self.sr_ratio ** 2

        def split(t):
            return t.reshape(b, -1, self.num_heads,
                             self.head_dim).transpose(1, 2)

        kv = self.norm(x[:, n - m * r:].reshape(b, m, r, c).mean(dim=2))
        out = layers.softmax_attention(
            split(layers.linear(x, self.q)), split(layers.linear(kv, self.k)),
            split(layers.linear(kv, self.v)), self.scale)
        out = out.transpose(1, 2).reshape(b, n, c).to(x.dtype)
        return layers.linear(out, self.proj)

    monkeypatch.setattr(mv.EMHSA, "forward", wrong_tokens)
    with pytest.raises(AssertionError, match="past the limits"):
        chip_smoke.medvit_f32_gate(card, cpu, x, labels, draws_of)


def test_medvit_bf16_gate(on_cpu):
    cfg32, model32, _ = _medvit_pair(scale=1.0)
    cfg = cfg32.replace(FP16=True)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(model32.state_dict())
    images = np.random.default_rng(0).standard_normal(
        (4, 36, 40, 20, 1)).astype(np.float16)
    assert chip_smoke.medvit_bf16_gate(model, model32, images, cfg) < 1

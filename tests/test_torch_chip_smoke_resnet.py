"""chip_smoke.py's ResNet slice at a tiny size: K5 parity and its mutants,
and the ResNet eval and training phases (split from
tests/test_torch_chip_smoke.py, whose shared pieces it imports).
"""


import numpy as np
import pytest
import torch

import chip_smoke
from vsn_tpu_torch.config import load_config
from vsn_tpu_torch.models import build_model
from vsn_tpu_torch.train.step import init_train_state
from test_torch_chip_smoke import ROOT, _run_mutated_chip_smoke, one_thread


def _stem_cases():
    gen = torch.Generator().manual_seed(9)
    return {f"{dt} {geom}": chip_smoke.stem_case(geom, 2, getattr(torch, dt),
                                                torch.device("cpu"), gen)
            for dt in ("float32", "bfloat16") for geom in chip_smoke.STEM_GEOMS}


def _roll_taps(kernel):
    """The kernel's taps shifted by one (tap t reads tap t - 1's weights)."""
    return kernel.reshape(-1, kernel.shape[-1]).roll(1, 0).reshape(
        kernel.shape)


STEM_MUTANTS = {  # name -> (wrapper, mutant of its plain version)
    "tap order shifted by one (K5f)": (
        "stem_im2col", lambda plain: lambda x, k, s, p, dt: plain(
            x, _roll_taps(k), s, p, dt)),
    "tap order shifted by one (K5w)": (
        "stem_im2col_dw", lambda plain: lambda x, g, ks, s, p, dt:
        _roll_taps(plain(x, g, ks, s, p, dt))),
    "stride-2 offset off by one (K5f)": (
        "stem_im2col", lambda plain: lambda x, k, s, p, dt: plain(
            x.roll(1, dims=2), k, s, p, dt)),
    "stride-2 offset off by one (K5w)": (
        "stem_im2col_dw", lambda plain: lambda x, g, ks, s, p, dt: plain(
            x.roll(1, dims=2), g, ks, s, p, dt)),
    "split-K reduction over one slice only (K5w)": (
        "stem_im2col_dw", lambda plain: lambda x, g, ks, s, p, dt: plain(
            x[:1], g[:1], ks, s, p, dt)),
}


def test_stem_plain_versions_pass_every_case():
    worst = chip_smoke.stem_parity_phase(_stem_cases(),
                                         chip_smoke.stem_table())
    assert set(worst) == set(chip_smoke.STEM)
    assert all(err == 0.0 for err in worst.values())


@pytest.mark.parametrize("mutant", sorted(STEM_MUTANTS))
def test_a_stem_kernel_with_a_wrong_index_fails(mutant):
    name, make = STEM_MUTANTS[mutant]
    table = chip_smoke.stem_table()
    table[name] = (make(table[name][1]), table[name][1])
    with pytest.raises(AssertionError, match=name):
        chip_smoke.stem_parity_phase(_stem_cases(), table)


def test_stem_dw_bits_holds_two_launches_to_the_same_bits():
    """The K5w determinism check on the CPU (the plain version, the same
    bits twice) passes; a K5w whose second launch moves one element by one
    f32 step fails it, naming the case."""
    cases = {k: v for k, v in _stem_cases().items() if "bfloat16" in k}
    table = chip_smoke.stem_table()
    chip_smoke.stem_dw_bits(cases, table)
    calls = []

    def wobbly(*args):
        dw = table["stem_im2col_dw"][1](*args).contiguous()
        calls.append(1)
        if len(calls) % 2 == 0:
            dw.view(-1)[0] = torch.nextafter(dw.view(-1)[0],
                                             torch.tensor(float("inf")))
        return dw

    table["stem_im2col_dw"] = (wobbly, table["stem_im2col_dw"][1])
    with pytest.raises(AssertionError, match="give other dW bits: "
                                             "bfloat16"):
        chip_smoke.stem_dw_bits(cases, table)


def test_stem_times_plumbing_on_cpu(monkeypatch):
    """Phase 10's timing on the CPU, clocks replaced: per kernel the
    wrapper's call, the FMA route's on the same bf16 inputs, the plain
    version's and the library call's, each run."""
    seen = []

    def events_ms(fn, reps=3, queued=False):
        fn()
        seen.append(reps)
        return float(len(seen))

    monkeypatch.setattr(chip_smoke, "cuda_ms", events_ms)
    case = _stem_cases()[f"bfloat16 {chip_smoke.STEM_GEOMS[0]}"]
    got = chip_smoke.stem_times(*case, chip_smoke.stem_table())
    assert got == {"stem_im2col": (1.0, 2.0, 3.0, 4.0),
                   "stem_im2col_dw": (5.0, 6.0, 7.0, 8.0)}
    rep = chip_smoke.LAUNCH_REPS
    assert seen == [rep, rep, 1, rep] * 2


RESNET_TINY = dict(RESNET_VARIANT="resnet10", IMG_SIZE=[16, 18, 16],
                   BATCH_SIZE=2, EFFECTIVE_BATCH_SIZE=4, USE_SAM=True,
                   USE_EMA=True, USE_MIXUP=True, MIXUP_PROB=0.5,
                   LABEL_SMOOTHING=0.1, SEED=0)


def test_resnet_phases_rehearsal_on_cpu():
    """The ResNet eval and training phases' pieces at a tiny size: refreshed
    statistics, Evaluator with the model's and with substituted weights,
    head-dropout draws, every parameter reached, the statistics moved and
    the EMA's apart, and the plain-stem route equal to the kernel route
    (both are the plain versions here)."""
    from vsn_tpu_torch.eval.evaluate import Evaluator
    from vsn_tpu_torch.models.resnet3d import init_weights as resnet_init
    from vsn_tpu_torch.train.step import eval_params

    cpu = torch.device("cpu")
    cfg = load_config(RESNET_TINY, preset=chip_smoke.RESNET_PRESET)
    assert cfg.DROPOUT == 0.1 and cfg.gradient_accumulation_steps() == 2
    model = resnet_init(build_model(cfg, device="cpu"),
                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    images = (rng.standard_normal((4, 16, 18, 16, 1)) * 50 + 100).astype(
        np.float16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    stats = chip_smoke.refresh_statistics(model, cfg, images, 2)
    assert all(not torch.equal(v, before[k]) for k, v in stats.items())
    evaluator = Evaluator(cfg, model, batch_size=2)
    probs = evaluator.predict(images)
    chip_smoke.check_probs(probs, 4, 5)
    with chip_smoke.plain_stem():
        chip_smoke.compare_probs("tiny", probs, evaluator.predict(images))
    with pytest.raises(AssertionError):
        chip_smoke.compare_probs("tiny", probs, probs[:, ::-1].copy())

    state = init_train_state(cfg, model)
    initial = state.params.flat.clone()
    initial_stats = state.model_state.flat.clone()
    batch = chip_smoke.train_batch(cfg, cpu, 5)
    draws = chip_smoke.Draws(model, 2, cpu, 0)
    assert draws(0, 0, 0).shape == (2, 512)
    chip_smoke.reach_every_parameter(model, cfg, state, batch, draws, "tiny")
    with torch.no_grad():
        state.model_state.flat.copy_(initial_stats)
    sync = lambda: None
    kernel, _ = chip_smoke.train_route(model, cfg, state, batch, draws, 1,
                                       sync)
    after0 = state.params.flat.clone()
    more, _ = chip_smoke.train_route(model, cfg, state, batch, draws, 1, sync)
    chip_smoke.params_moved(state, initial, after0, "tiny")
    chip_smoke.statistics_checks(state, initial_stats)
    ema_probs = evaluator.predict(images[:2], eval_params(state, use_ema=True))
    chip_smoke.check_probs(ema_probs, 2, 5)
    with torch.no_grad():
        state.params.flat.copy_(initial)
        state.model_state.flat.copy_(initial_stats)
    pstate = init_train_state(cfg, model)
    with chip_smoke.plain_stem():
        plain, _ = chip_smoke.train_route(model, cfg, pstate, batch, draws, 2,
                                          sync)
    # the plain stem's weight gradient comes from autograd's conv VJP, the
    # kernel route's from stem_dw_reference: sums in another order
    rel = chip_smoke.check_train_metrics(kernel + more, plain)
    assert max(rel.values()) < 1e-5


# One-line edits of csrc/stem_im2col.cu that chip_smoke.py must reject on the
# card (exit 1, in its K5 parity phase): name -> (line, its mutant)
SOURCE_MUTANTS = {
    "tap order shifted by one (K5f weights)": (
        "w_s[i] = round_to<T>(wt[i]);",
        "w_s[i] = round_to<T>(wt[(i + g.c) % (taps * g.c)]);"),
    "stride-2 offset off by one (the halo's rows)": (
        "const int y = yo0 * g.sy - g.py + r;",
        "const int y = yo0 * g.sy - g.py + r + (g.sy == 2);"),
    "split-K reduction over one slice only (K5w)": (
        "if (!active) return;",
        "if (!active || blockIdx.x != 0) return;"),
    # the tensor-core bodies (bf16)
    "fragment address one depth pair over (K5f tensor-core body)": (
        "base[mt][hf] = r * g.sy * g.wp + SX * xo + 2 * tq + m.lpad - m.f - "
        "g.px;",
        "base[mt][hf] = r * g.sy * g.wp + SX * xo + 2 * tq + m.lpad - m.f - "
        "g.px + 2;"),
    "partials summed in an order that varies between runs (K5w "
    "tensor-core body)": (
        "for (int b = 0; b < blocks; ++b) s += part[(long long)b * n + i];",
        "for (int b = 0, r = (int)(clock64() % blocks); b < blocks; ++b) "
        "s += part[(long long)((b + r) % blocks) * n + i];"),
    "ring slot of the group's planes one over (K5w tensor-core body)": (
        "poff[dz] = ((zo * g.sz + dz) % m.nslot) * g.slab_rows * g.wp;",
        "poff[dz] = ((zo * g.sz + dz + 1) % m.nslot) * g.slab_rows * g.wp;"),
}
# what chip_smoke.py's K5 phase says of each mutant: the parity, or the bits
# of two K5w launches on the same inputs
MUTANT_FAILS = {"partials summed in an order that varies between runs (K5w "
                "tensor-core body)": "two launches on the same inputs give "
                                     "other dW bits"}
STEM_SOURCE = ROOT / "vsn_tpu_torch" / "csrc" / "stem_im2col.cu"


@pytest.mark.parametrize("mutant", sorted(SOURCE_MUTANTS))
def test_source_mutants_name_one_line_of_the_source(mutant):
    line, new = SOURCE_MUTANTS[mutant]
    assert STEM_SOURCE.read_text().count(line) == 1 and new != line


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(SOURCE_MUTANTS))
def test_a_mutated_stem_source_makes_chip_smoke_fail(mutant, tmp_path):
    """chip_smoke.py run from a copy of the port (the script and its
    package) whose stem kernel has one line mutated exits 1 in its K5
    phase: the parity, or the bits of two K5w launches."""
    res = _run_mutated_chip_smoke(STEM_SOURCE, *SOURCE_MUTANTS[mutant],
                                  tmp_path)
    assert res.returncode == 1
    assert MUTANT_FAILS.get(mutant, "stem kernels disagree with their plain "
                                    "versions") in res.stderr

"""Time MedViT-S's depthwise and grouped 3-D convs (bf16, micro-batch 8 at
144x168x144) forward and forward + backward in the two layouts cuDNN can
take: the channels-last view the model keeps, and a contiguous [B, C, D,
H, W] copy (what ``ops/conv_unfold.conv3d_channels_last`` runs a depthwise
conv on, on the card).

    python -m vsn_tpu_torch.probes.conv_layouts

Needs a CUDA device; prints one line a case and layout (CUDA events, the
mean of 5 calls after one warm-up call).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (label, batch, channels, grid, groups): the LFF's depthwise convs at
# stages 1-3 and MHCA's grouped convs (C / 32 groups) at stages 1 and 3
CASES = (("LFF depthwise, stage 1", 8, 288, (36, 42, 36), 288),
         ("MHCA grouped, stage 1", 8, 96, (36, 42, 36), 3),
         ("LFF depthwise, stage 2", 8, 576, (18, 21, 18), 576),
         ("LFF depthwise, stage 3", 8, 1152, (9, 11, 9), 1152),
         ("MHCA grouped, stage 3", 8, 384, (9, 11, 9), 12))


def events_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(device: str = "cuda") -> list[tuple[str, str, float, float]]:
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for label, b, c, grid, groups in CASES:
        w = torch.randn(c, c // groups, 3, 3, 3, device=device,
                        dtype=torch.bfloat16, requires_grad=True)
        for layout in ("channels-last view", "contiguous NCDHW"):
            x = torch.randn(b, *grid, c, device=device,
                            dtype=torch.bfloat16).permute(0, 4, 1, 2, 3)
            wl = w
            if layout == "contiguous NCDHW":
                x = x.contiguous()
            else:
                wl = w.contiguous(memory_format=torch.channels_last_3d)
            x.requires_grad_(True)

            def forward():
                return F.conv3d(x, wl, padding=1, groups=groups)

            def both():
                y = forward()
                y.backward(torch.ones_like(y))

            rows.append((label, layout, events_ms(forward), events_ms(both)))
            print(f"{label} [{b}, {c}, {', '.join(map(str, grid))}] groups "
                  f"{groups}, {layout}: forward {rows[-1][2]:.3f} ms, forward "
                  f"+ backward {rows[-1][3]:.3f} ms", flush=True)
    return rows


if __name__ == "__main__":
    main()

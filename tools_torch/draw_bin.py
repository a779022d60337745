"""Inspect a GR interleaved-cf32 capture — drawGrBin.py parity.

Plots |x|, re/im and the STF autocorrelation trigger metric to a PNG
(matplotlib Agg; this image is headless), or prints a terminal summary with
``--text``:

  python tools_torch/draw_bin.py capture.bin [--start N] [--num N]
      [--out plot.png] [--text]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gr_ieee80211_tpu_torch.utils.io import read_cf32


def stf_metric(x: np.ndarray) -> np.ndarray:
    prod = x[:-16] * np.conj(x[16:])
    c = np.convolve(prod, np.ones(48), "valid")
    p = np.convolve(np.abs(x) ** 2, np.ones(64), "valid")
    n = min(len(c), len(p))
    return np.abs(c[:n]) / np.maximum(p[:n], 1e-12)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--num", type=int, default=200000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--text", action="store_true")
    args = ap.parse_args()

    x = read_cf32(args.path)[args.start: args.start + args.num]
    m = stf_metric(x) if len(x) > 80 else np.zeros(1)
    print(f"{args.path}: {len(x)} samples from {args.start}")
    print(f"  rms {np.sqrt(np.mean(np.abs(x)**2)):.6f}  "
          f"peak {np.abs(x).max():.6f}  "
          f"trigger metric max {m.max():.3f}")
    above = m > 0.3
    edges = np.flatnonzero(above[1:] & ~above[:-1])
    print(f"  plateau rising edges (>0.3): {len(edges)}"
          + (f", first at {args.start + int(edges[0])}" if len(edges) else ""))
    if args.text:
        # coarse terminal envelope
        mag = np.abs(x)
        bins = np.array_split(mag, 80)
        mx = max(b.max() for b in bins) or 1.0
        print("  |x| envelope:")
        print("  " + "".join(" .:-=+*#%@"[min(9, int(b.max() / mx * 9))]
                             for b in bins))
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(3, 1, figsize=(12, 7), sharex=False)
    t = np.arange(args.start, args.start + len(x))
    axes[0].plot(t, np.abs(x), lw=0.4)
    axes[0].set_ylabel("|x|")
    axes[1].plot(t, x.real, lw=0.4, label="re")
    axes[1].plot(t, x.imag, lw=0.4, label="im")
    axes[1].legend(loc="upper right")
    axes[2].plot(t[: len(m)], m, lw=0.4)
    axes[2].axhline(0.3, color="r", ls="--", lw=0.6)
    axes[2].set_ylabel("STF autocorr")
    out = args.out or (os.path.splitext(args.path)[0] + ".png")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    print("  plot written to", out)


if __name__ == "__main__":
    main()

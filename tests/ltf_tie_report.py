"""How far the port's LTF timing agrees with the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python tests/ltf_tie_report.py

The timing is the argmax of the lag-64 autocorrelation metric
``ac = |a| / sqrt(pw0 * pw64)`` over a flat peak, so its last bits decide
near-ties.  For the port's metric as it computes it
(``ops.frontend._ltf_metric``: XLA:CPU's FMA contraction and Newton
rsqrt) and for the metric as written (two roundings, a division), this
prints one JSON line with:

* ``bench_18db``: starts that differ from the reference's ``_sync_core``
  over the 4096 packets of ``bench.py``'s 18 dB stream, and the largest
  shift;
* ``metric_values``: metric values on those packets' windows that differ
  from the ones XLA computes, of all of them;
* ``seed77``: starts that differ between the JAX and the port engine on
  the streams of ``tests/test_torch_mu.py::test_mu_engine_batched_rx``
  at the reference's seed 77 (each station, with and without its MU
  role).

A test helper, not a test: it imports both packages.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax                                        # noqa: E402
import jax.numpy as jnp                           # noqa: E402

from gr_ieee80211_tpu.models import rx as JRX     # noqa: E402
from gr_ieee80211_tpu.ops import frontend as JFE  # noqa: E402
from gr_ieee80211_tpu.ops.cplx import CF as JCF, from_host  # noqa: E402
from gr_ieee80211_tpu_torch.models import rx as PRX         # noqa: E402
from gr_ieee80211_tpu_torch.ops import frontend as PFE      # noqa: E402
from gr_ieee80211_tpu_torch.ops.cplx import CF as PCF, from_numpy_cf  # noqa


def _as_written(a: PCF, y: torch.Tensor) -> torch.Tensor:
    return a.abs() / torch.sqrt(y)


@jax.jit
def _xla_metric(re, im):
    """The reference's ``ac`` on (B, 368) windows, as XLA computes it."""
    wins = JCF(re, im)
    n = wins.shape[1]
    npts = n - 128
    a = JFE._movsum_cf(wins[:, : n - 64].mul_conj(wins[:, 64:]), 64)
    pw = JFE._movsum(wins.abs2(), 64)
    den = jnp.sqrt(jnp.maximum(pw[:, :npts] * pw[:, 64: 64 + npts], 1e-24))
    return a[:, :npts].abs() / den


def _port_metric(re, im):
    wins = PCF(torch.from_numpy(re), torch.from_numpy(im))
    n = wins.shape[1]
    npts = n - 128
    prod = wins[:, : n - 64].mul_conj(wins[:, 64:])
    are, aim, pw = PFE._movsums([prod.re, prod.im, wins.abs2()], [64] * 3)
    y = torch.clamp(pw[:, :npts] * pw[:, 64: 64 + npts], min=1e-24)
    return PFE._ltf_metric(PCF(are[:, :npts], aim[:, :npts]), y).numpy()


def bench_18db() -> dict:
    from test_torch_rx import _bench_stream_18db
    _, _, s = _bench_stream_18db(4096)
    pcf = from_numpy_cf(s, "cpu")
    p0 = PCF(pcf.re[0], pcf.im[0])
    trigs = PRX.RxEngine(device="cpu").detect(p0).astype(np.int32)
    ref = np.asarray(JRX._sync_core(from_host(s[0]), jnp.asarray(trigs))[0])
    got = PRX._sync_core(p0, torch.from_numpy(trigs))[0].numpy()
    d = got.astype(np.int64) - ref
    wins = PFE.gather_windows_bf16(p0, torch.from_numpy(trigs // 16 * 16),
                                   464)
    re = np.ascontiguousarray(wins.re[:, 80:448].numpy())
    im = np.ascontiguousarray(wins.im[:, 80:448].numpy())
    xla = np.asarray(_xla_metric(re, im))
    port = _port_metric(re, im)
    return {"packets": len(trigs), "starts_differ": int((d != 0).sum()),
            "max_shift": int(np.abs(d).max())}, {
        "values": int(xla.size), "differ": int((port != xla).sum())}


def seed77() -> dict:
    from gr_ieee80211_tpu.gold import channel, rx as grx, tx as gtx
    from test_torch_mu import _h_sta, _mu_frames, _sounded_q
    rng = np.random.default_rng(77)
    h_sta = _h_sta(rng)
    bfq = _sounded_q(rng, h_sta, lambda s: grx.receive(s)[0].ndp_chan)
    mu, ams, _ = _mu_frames((b"engine user zero " * 7,
                             b"ENGINE USER ONE " * 5))
    wave = gtx.tx_waveform_mu(mu, ams, bfq)
    n, moved = 0, 0
    for u in range(2):
        stream = channel.frame_stream(channel.mimo_channel(wave, h_sta[u]),
                                      1.0, 150.0, num=3, gap=1200)
        stream = channel.awgn(stream, 0.012 / 10 ** (30 / 20), rng)
        for kw in (dict(mu_pos=u, mu_gid=2), {}):
            ref = JRX.RxEngine(nrx=1, **kw).process(stream)
            got = PRX.RxEngine(nrx=1, device="cpu", **kw).process(stream)
            n += len(ref)
            moved += sum(a.start != b.start for a, b in zip(ref, got))
    return {"results": n, "starts_differ": moved}


def main():
    out = {}
    for name in ("port", "as_written"):
        if name == "as_written":
            PFE._ltf_metric = _as_written
        bench, values = bench_18db()
        out[name] = {"bench_18db": bench, "metric_values": values,
                     "seed77": seed77()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

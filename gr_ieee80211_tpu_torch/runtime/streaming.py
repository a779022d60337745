"""Streaming executors: the rx.grc / tx.grc flowgraph equivalents.

The reference runs its PHY as GNU Radio flowgraphs — a scheduler moving an
unbounded sample stream through per-block state machines.  Here the same
roles are a handful of explicit pieces:

* ingest: the native C++ :class:`~.native.UdpIngest` thread (or a file
  replayer) fills an SPSC :class:`~.native.IqRing`;
* :class:`RxStreamer` pulls fixed-size overlap-save blocks from the ring
  (halo >= packet span so boundary-straddling packets decode), runs the
  batched :class:`~..models.rx.RxEngine` per block on its device, and
  publishes decoded MPDUs / NDP channel reports over the reference UDP wire
  (:9527) via :class:`~.udp_phy.PhyRxReporter`;
* :class:`TxStreamer` is the :class:`~.udp_phy.PhyTxServer` sink that frames
  synthesized bursts into a continuous sample stream (file or UDP cf32),
  the pad/pad2 + USRP-sink role.

Ownership rule across blocks: a packet belongs to the block where its
trigger fell; triggers inside the halo are left for the next block (the
ring's read pointer only advances by the block length).

Copy of ``gr_ieee80211_tpu.runtime.streaming``; the engine is duck-typed
(``begin_process`` / ``finish_process``), so the port's
``models.rx.RxEngine(device=...)`` runs under it on its own device.
"""
from __future__ import annotations

import socket
import threading
import time

import numpy as np

from . import native as NAT
from .udp_phy import PhyRxReporter


class RxStreamer(threading.Thread):
    """Continuously decode one or more IqRings in overlap-save blocks.

    ``ring`` may be a single :class:`~.native.IqRing` or a list of one per
    RX antenna (the rx2.grc role): blocks are pulled from all rings in
    lockstep — a block is processed only when EVERY ring holds
    block_len + halo samples, so the antennas stay sample-aligned (the
    producers must feed them at the same rate, as USRP channels do).

    halo must cover the longest expected packet plus sync lookahead
    (MCS0 500 B VHT ~= 14k samples; default 16384).
    """

    def __init__(self, ring, engine, block_len: int = 1 << 19,
                 halo: int = 16384, reporter: PhyRxReporter | None = None,
                 on_result=None, poll_s: float = 0.01):
        super().__init__(daemon=True)
        self.rings = list(ring) if isinstance(ring, (list, tuple)) else [ring]
        self.nrx = len(self.rings)
        self.engine = engine
        self.block_len = block_len
        self.halo = halo
        self.reporter = reporter
        self.on_result = on_result
        self.poll_s = poll_s
        self.n_blocks = 0
        #: blocks consumed from the ring (>= n_blocks by the one in-flight
        #: pipelined block; the drain rule must count it)
        self.n_begun = 0
        self.n_packets = 0
        self.n_ok = 0
        #: the backlog: most samples seen waiting in the fullest ring; a
        #: reader that wants it per interval sets it back to 0
        self.fill_max = 0
        #: per-(fmt, mcs) [ok, total, snr_sum, rssi_sum] counters — the
        #: reference decode block's printed per-MCS tallies with CFO/SNR/RSSI
        #: are its measurement API (lib/decode_impl.cc:42-45,393-411); here
        #: they are a queryable dict (see :meth:`counter_summary`)
        self.counters: dict[tuple, list] = {}
        #: the exception that ended :meth:`run`, if one did
        self.error: BaseException | None = None
        self._stop_evt = threading.Event()

    def counter_summary(self) -> dict:
        """Per-(fmt, mcs) {ok, total, snr_db_mean, rssi_mean} — the
        queryable twin of the reference's printed per-MCS tallies."""
        out = {}
        for k, (ok, tot, snr, rssi) in self.counters.items():
            out[k] = dict(ok=ok, total=tot,
                          snr_db_mean=snr / tot if tot else 0.0,
                          rssi_mean=rssi / tot if tot else 0.0)
        return out

    @property
    def ring(self) -> NAT.IqRing:
        return self.rings[0]

    def stop(self, drain: bool = False, timeout: float = 60.0):
        if drain:
            # keep topping the rings up with silence until every real sample
            # has been inside some block's private (non-halo) span.  The
            # count is exact: ceil(remaining/block_len) more blocks — a
            # fill-threshold exit instead would strand a packet whose
            # trigger fell in the last real block's halo (deferred by the
            # ownership rule to a block that never runs).
            deadline = time.time() + timeout
            remaining = max(r.fill for r in self.rings)
            # count from blocks BEGUN: a pipelined in-flight block has
            # already consumed its samples from the ring, so deriving the
            # target from n_blocks alone would stop one block early and
            # strand its halo-deferred packets
            target = self.n_begun + -(-remaining // self.block_len)
            while time.time() < deadline and self.n_blocks < target:
                for r in self.rings:
                    need = self.block_len + self.halo + 16 - r.fill
                    if need > 0:
                        r.write(np.zeros(need, np.complex64))
                time.sleep(self.poll_s)
        self._stop_evt.set()

    #: left-context samples prepended to every block so a plateau straddling
    #: the previous boundary is not re-detected as a fresh edge start (same
    #: fix as parallel.mesh.rx_chain_sp's LH halo); must exceed the STF span
    LCTX = 256

    def _begin_block(self, block: np.ndarray, t0: int):
        """block: (nrx, block_len + halo).  Dispatches the upload + front
        end asynchronously (engine.begin_process) and returns a pending-
        block token for :meth:`_finish_block`: the double-buffering that
        lets block k+1's host->device upload and front end be queued
        before block k's decode finishes."""
        view = np.concatenate([self._lctx, block], axis=1)
        first = not self._saw_block
        self._saw_block = True
        self._lctx = block[:, self.block_len - self.LCTX: self.block_len]
        lo = 0 if first else self.LCTX   # block 0 owns its zero left pad too
        if hasattr(self.engine, "begin_process"):
            return (self.engine.begin_process(view), None, lo, t0)
        return (None, view, lo, t0)      # gold engines: no async path

    def _finish_block(self, pending):
        handle, view, lo, t0 = pending
        if handle is not None:
            res = self.engine.finish_process(handle)
        else:
            res = self.engine.process(view)
        for r in res:
            # ownership by the TRIGGER index: packets triggering in the left
            # context belong to the previous block, packets triggering in
            # the right halo to the next
            if not (lo <= r.trig < self.LCTX + self.block_len):
                continue
            r.trig -= self.LCTX
            r.start -= self.LCTX
            self.n_packets += 1
            c = self.counters.setdefault((r.fmt, r.mcs), [0, 0, 0.0, 0.0])
            c[1] += 1
            c[2] += float(getattr(r, "snr_db", 0.0))
            c[3] += float(getattr(r, "rssi", 0.0))
            if r.ok:
                self.n_ok += 1
                c[0] += 1
            r.start += t0         # absolute sample index in the stream
            r.trig += t0
            if self.reporter is not None and r.ok:
                self.reporter.report(r)
            if self.on_result is not None:
                self.on_result(r)

    def run(self):
        t0 = 0
        self._lctx = np.zeros((self.nrx, self.LCTX), np.complex64)
        self._saw_block = False
        need = self.block_len + self.halo
        pending = None                  # one in-flight block (depth-2 pipe)
        try:
            while not self._stop_evt.is_set():
                fills = [r.fill for r in self.rings]
                self.fill_max = max(self.fill_max, *fills)
                # lockstep: consume only when EVERY antenna ring has a block
                if any(f < need for f in fills):
                    if pending is not None:
                        # idle: drain the in-flight block so results (and
                        # n_blocks, which stop(drain=True) watches) land
                        self._finish_block(pending)
                        pending = None
                        self.n_blocks += 1
                    time.sleep(self.poll_s)
                    continue
                rows = [r.read_block(self.block_len, self.halo)
                        for r in self.rings]
                # fills were checked and we are the sole consumer, so a None
                # here means the antennas desynced: that must be fatal
                if any(b is None for b in rows):
                    raise RuntimeError("ring desync")
                # dispatch block k's upload/front BEFORE finishing block
                # k-1, so k's transfer is queued while k-1's bucket
                # decodes and readbacks run
                nxt = self._begin_block(np.stack(rows), t0)
                self.n_begun += 1
                t0 += self.block_len
                if pending is not None:
                    self._finish_block(pending)
                    self.n_blocks += 1
                pending = nxt
            if pending is not None:
                self._finish_block(pending)
                self.n_blocks += 1
        except Exception as e:          # surface thread death to the owner
            self.error = e
            raise


class TxStreamer:
    """PhyTxServer sink: frame bursts into continuous cf32 stream(s).

    Mirrors pad/pad2's burst framing (preamble already inside the waveform;
    this adds inter-burst gaps) and the flowgraph's sample sinks — one file
    and/or one UDP cf32 stream PER ANTENNA (pairs with UdpIngest on the RX
    side for loopback).  Multi-antenna parity with pad2
    (lib/pad2_impl.cc:154-201): every configured output stream gets a burst
    of identical length; a 1-stream waveform through a 2-antenna sink
    zero-fills antenna 1 so the antennas never skew.

    ``path``/``udp_addr`` accept a single value (antenna 0 only) or a list
    with one entry per antenna; n_streams = the longest list.

    ``timed=True`` enables pad2's scheduled-emission contract
    (lib/pad2_impl.cc:154-160: UHD ``tx_time`` tags at now + 1 ms): each
    burst is placed at stream sample ``current position + lead`` with
    explicit inter-burst silence, so burst starts are sample-accurate in
    the emitted stream (``lead`` defaults to 1 ms at 20 Msps).  The
    stream-position clock stands in for the USRP hardware clock — no
    radio exists here, but the emitted artifact carries the same timing.
    """

    def __init__(self, path=None, udp_addr=None, gap: int = 1200,
                 amp: float = 1.0, timed: bool = False, lead: int = 20000):
        self.gap = gap
        self.amp = amp
        self.timed = timed
        self.lead = lead
        #: absolute sample index of the next write in the emitted stream
        self.stream_pos = 0
        #: absolute start sample of each emitted burst (timed mode)
        self.burst_starts: list[int] = []
        paths = list(path) if isinstance(path, (list, tuple)) else \
            ([path] if path else [])
        addrs = list(udp_addr) if udp_addr and isinstance(udp_addr[0], tuple) \
            else ([udp_addr] if udp_addr else [])
        self.n_streams = max(len(paths), len(addrs), 1)
        self._f = [open(p, "ab") if p else None
                   for p in paths + [None] * (self.n_streams - len(paths))]
        self._addr = addrs + [None] * (self.n_streams - len(addrs))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM) \
            if any(self._addr) else None
        self.n_bursts = 0

    def __call__(self, waveform: np.ndarray, req=None):
        w = np.atleast_2d(np.asarray(waveform, np.complex64)) * self.amp
        if self.timed:
            # scheduled emission: silence up to stream_pos + lead, then
            # the burst — sample-accurate placement (the tx_time contract)
            pre = self.lead
            start = self.stream_pos + pre
            self.burst_starts.append(start)
            n = pre + w.shape[1]
            off = pre
        else:
            n = w.shape[1] + self.gap
            off = 0
        for i in range(self.n_streams):
            burst = np.zeros(n, np.complex64)   # pad2 zero-fill for 1SS
            if i < w.shape[0]:
                burst[off: off + w.shape[1]] = w[i]
            if self._f[i] is not None:
                burst.tofile(self._f[i])
                self._f[i].flush()
            if self._addr[i] is not None:
                raw = burst.tobytes()
                # keep datagrams under typical 64 KiB limits: 4096 samples
                step = 4096 * 8
                for o in range(0, len(raw), step):
                    self._sock.sendto(raw[o: o + step], self._addr[i])
        self.stream_pos += n
        self.n_bursts += 1

    def close(self):
        for f in self._f:
            if f:
                f.close()
        if self._sock:
            self._sock.close()

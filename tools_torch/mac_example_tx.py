"""MAC -> PHY TX demo over UDP :9528 (macExampleGrTx.py equivalent).

Builds UDP/IP/LLC/MAC frames and sends 5-byte-header transmit requests for
every supported format/MCS to the PHY TX server (run `tx_daemon.py` or a
PhyTxServer first, or point it at a GNU Radio flowgraph — the wire format is
identical).
"""
import os
import socket
import struct
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
from gr_ieee80211_tpu_torch.gold import mac

PHY_ADDR = ("127.0.0.1", 9528)


def gr_data(fmt: int, mcs: int, nss: int, psdu: bytes) -> bytes:
    return bytes([fmt, mcs, nss]) + struct.pack("<H", len(psdu)) + psdu


def main():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    payload = mac.llc_ip_udp(b"hello from the tpu mac example tx",
                             "192.168.13.1", "192.168.13.2", 52001, 52002)
    mpdu = mac.qos_data_frame(payload, "f4:69:d5:80:0f:a0",
                              "00:c0:ca:b1:5b:e1", "f4:69:d5:80:0f:a0", 42)
    ampdu = mac.ampdu_aggregate_vht([mpdu])
    for mcs in range(8):
        sock.sendto(gr_data(0, mcs, 1, mpdu), PHY_ADDR)
        time.sleep(0.05)
    for mcs in range(8):
        sock.sendto(gr_data(1, mcs, 1, mpdu), PHY_ADDR)
        time.sleep(0.05)
    for mcs in range(9):
        sock.sendto(gr_data(2, mcs, 1, ampdu), PHY_ADDR)
        time.sleep(0.05)
    for mcs in range(8, 16):
        sock.sendto(gr_data(1, mcs, 2, mpdu), PHY_ADDR)
        time.sleep(0.05)
    for mcs in range(9):
        sock.sendto(gr_data(2, mcs, 2, ampdu), PHY_ADDR)
        time.sleep(0.05)
    print("sent 42 transmit requests to", PHY_ADDR)


if __name__ == "__main__":
    main()

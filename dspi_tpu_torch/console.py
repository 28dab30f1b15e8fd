"""Interactive console for a virtual DSPi — the host-app experience.

The twin of the JAX package's ``examples/console.py`` on the PyTorch port:
a miniature "DSPi Console" REPL speaking the vendor protocol against a
VirtualDSPi + Engine (the RP2350 float chain, 64 streams, no PDM sub).

Run:  python -m dspi_tpu_torch.console [--cpu]
(``--cpu`` runs the engine on the CPU; without it the engine runs on the
card and raises without one.)

Commands:
  eq <ch> <band> <type> <freq> <q> <gain>   set an EQ band
  vol <db> | preamp <ch> <db>               volumes
  route <in> <out> <gain_db> [inv]          matrix route
  out <n> on|off|mute|unmute                output control
  delay <out> <ms>                          output delay
  leveller on|off | crossfeed on|off        dynamics
  save <slot> | load <slot> | presets       preset system
  status | bulk | run [ms]                  telemetry / audio
  quit
"""

from __future__ import annotations

import shlex
import struct
import sys

import numpy as np
import torch

from . import FilterType, Platform
from .chain import Engine
from .control import requests as R
from .control.device import VirtualDSPi
from .runtime.telemetry import EngineTelemetry

FILTER_NAMES = {t.name.lower(): t for t in FilterType}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    dev = VirtualDSPi(Platform.RP2350)
    eng = None
    tele = EngineTelemetry()
    rng = np.random.default_rng(1)

    def ensure_engine():
        nonlocal eng
        if eng is None:
            print("building engine (64 streams)...")
            eng = Engine(dev.cfg, n_streams=64, pdm=False, device=device)
            dev.dirty = False
        elif dev.dirty:
            dev.commit(eng)
        return eng

    print("dspi_tpu_torch console — 'help' for commands")
    while True:
        try:
            line = input("dspi> ").strip()
        except EOFError:
            break
        if not line:
            continue
        try:
            cmd, *a = shlex.split(line)
            if cmd == "quit":
                break
            elif cmd == "help":
                print(__doc__)
            elif cmd == "eq":
                ch, band = int(a[0]), int(a[1])
                typ = FILTER_NAMES[a[2]]
                pkt = struct.pack("<BBBBfff", ch, band, int(typ), 0,
                                  float(a[3]), float(a[4]), float(a[5]))
                dev.set(R.SET_EQ_PARAM, 0, pkt)
                print("ok")
            elif cmd == "vol":
                dev.set(R.SET_MASTER_VOLUME, 0, struct.pack("<f", float(a[0])))
            elif cmd == "preamp":
                dev.set(R.SET_PREAMP_CH, int(a[0]),
                        struct.pack("<f", float(a[1])))
            elif cmd == "route":
                inv = len(a) > 3 and a[3] == "inv"
                pkt = struct.pack("<BBBBf", int(a[0]), int(a[1]), 1,
                                  1 if inv else 0, float(a[2]))
                dev.set(R.SET_MATRIX_ROUTE, 0, pkt)
            elif cmd == "out":
                o = int(a[0])
                if a[1] in ("on", "off"):
                    dev.set(R.SET_OUTPUT_ENABLE, o,
                            b"\x01" if a[1] == "on" else b"\x00")
                    got = dev.get(R.GET_OUTPUT_ENABLE, o)
                    if a[1] == "on" and got == b"\x00":
                        print("refused (core-1 PDM/EQ-worker interlock)")
                else:
                    dev.set(R.SET_OUTPUT_MUTE, o,
                            b"\x01" if a[1] == "mute" else b"\x00")
            elif cmd == "delay":
                dev.set(R.SET_OUTPUT_DELAY, int(a[0]),
                        struct.pack("<f", float(a[1])))
            elif cmd == "leveller":
                dev.set(R.SET_LEVELLER_ENABLE, 0,
                        b"\x01" if a[0] == "on" else b"\x00")
            elif cmd == "crossfeed":
                dev.set(R.SET_CROSSFEED, 0,
                        b"\x01" if a[0] == "on" else b"\x00")
            elif cmd == "save":
                dev.set(R.PRESET_SAVE, int(a[0]))
                print("saved")
            elif cmd == "load":
                dev.set(R.PRESET_LOAD, int(a[0]))
                print("loaded")
            elif cmd == "presets":
                occupied = struct.unpack("<H", dev.get(R.PRESET_GET_DIR)[:2])[0]
                for s in range(10):
                    name = dev.get(R.PRESET_GET_NAME, s).split(b"\x00")[0]
                    mark = "*" if occupied & (1 << s) else " "
                    print(f"  [{mark}] {s}: {name.decode() or '(empty)'}")
            elif cmd == "status":
                st = dev.get(R.GET_STATUS, 9)
                n = dev.cfg.num_channels
                peaks = struct.unpack(f"<{n}H", st[:n * 2])
                print(f"peaks: {peaks}")
                print(f"load: {st[n*2]}%  clips: "
                      f"{struct.unpack('<H', st[n*2+2:n*2+4])[0]:011b}")
            elif cmd == "bulk":
                blob = dev.get(R.GET_ALL_PARAMS)
                print(f"{len(blob)} bytes, version {blob[0]}, "
                      f"platform {blob[1]}")
            elif cmd == "run":
                ms = int(a[0]) if a else 100
                e = ensure_engine()
                npkt = max(ms, 1)
                x = rng.integers(-20000, 20000,
                                 size=(npkt, 2, 48, e.n_streams)).astype(np.int32)
                tele.segment_begin()
                out = e.process(x)
                if e.device.type == "cuda":
                    torch.cuda.synchronize(e.device)
                rtf = tele.segment_end(npkt, 48, e.n_streams)
                tele.feed_device(dev, out)
                print(f"processed {ms} ms x {e.n_streams} streams "
                      f"({rtf:.0f}x RT)")
            else:
                print("unknown command; 'help'")
        except (ValueError, IndexError, KeyError) as e:
            print(f"error: {e}")


if __name__ == "__main__":
    main()

"""8x8 Omega network switch (paper Section 4.1).

log2(8) = 3 stages of four 2x2 switch elements route 64-bit packets whose
top 3 bits are the destination port.  The 2x2 element is the paper's
showcase for **peek** (Section 2.3 / Listing 1's pattern): the element
looks at the head packet of each input to decide routing *without
consuming it*, because the packet can only be consumed once the chosen
output has space — peek + try_write replaces the manual claim/buffer state
machine the paper shows in red.
"""

from __future__ import annotations

import numpy as np

from ..core import OStream, StepTask, channel, select, task
from ..core.synth import resolve_device
from .base import AppResult, simulate

PORTS = 8
STAGES = 3


def _inv_shuffle(p: int) -> int:
    """Which wire feeds switch-input position ``p`` after the perfect
    shuffle (wire w lands on position rotate-left(w), so position p is fed
    by rotate-right(p))."""
    return ((p >> 1) | ((p & 1) << (STAGES - 1))) & (PORTS - 1)


def build(n_packets: int = 64, seed: int = 0):
    rng = np.random.default_rng(seed)
    # packet = (dst << 61) | payload  — modeled as a (dst, payload) tuple
    dsts = rng.integers(0, PORTS, n_packets)
    payloads = rng.integers(0, 1 << 32, n_packets)
    received: dict[int, list] = {p: [] for p in range(PORTS)}

    def Source(outs):
        for d, pl in zip(dsts, payloads):
            outs[int(rng.integers(0, PORTS))].write((int(d), int(pl)))
        for o in outs:
            o.close()

    def Switch2x2(in0, in1, out0, out1, stage: int):
        """Route by bit (STAGES-1-stage) of dst.  Peek first; consume only
        once the destination output accepts the packet — the paper's
        Listing-1 pattern (no manual claim/buffer state machine).  When
        neither input can progress, ``select`` parks the task until *any*
        watched port changes (hardware ready/valid polling)."""
        bit = STAGES - 1 - stage
        open_in = [False, False]
        ins = [in0, in1]
        outs = [out0, out1]
        while not all(open_in):
            progress = False
            blockers = []       # the ports whose state change can unblock us
            for s in (0, 1):
                if open_in[s]:
                    continue
                ok, is_eot = ins[s].try_eot()
                if ok and is_eot:
                    ins[s].open()
                    open_in[s] = True
                    progress = True
                    continue
                ok, head = ins[s].try_peek()
                if not ok:
                    blockers.append(ins[s])          # waiting for a packet
                    continue
                port = (head[0] >> bit) & 1
                if outs[port].try_write(head):       # output has space?
                    ins[s].read()                    # now consume
                    progress = True
                    # opportunistic burst drain: forward the run of
                    # consecutive same-destination packets in one batch
                    # (peek each, stop at the first routed elsewhere)
                    while True:
                        ok, nxt = ins[s].try_peek()
                        if not ok or ((nxt[0] >> bit) & 1) != port:
                            break
                        if not outs[port].try_write(nxt):
                            break
                        ins[s].read()
                else:
                    blockers.append(outs[port])      # waiting for space
            if not progress and blockers:
                select(*blockers)
        out0.close()
        out1.close()

    def Sink(inp, port: int):
        received[port].extend(inp.read_transaction())

    def Top():
        # stage wiring: lines[s][i] carries packets entering stage s on
        # wire i (after the perfect-shuffle permutation)
        lines = [[channel(4, f"l{s}_{i}") for i in range(PORTS)]
                 for s in range(STAGES + 1)]
        t = task().invoke(Source, lines[0])
        for s in range(STAGES):
            for e in range(PORTS // 2):      # four 2x2 elements
                i0 = _inv_shuffle(2 * e)
                i1 = _inv_shuffle(2 * e + 1)
                t = t.invoke(Switch2x2, lines[s][i0], lines[s][i1],
                             lines[s + 1][2 * e], lines[s + 1][2 * e + 1],
                             s, name=f"SW{s}_{e}")
        for p in range(PORTS):
            t = t.invoke(Sink, lines[STAGES][p], p, name=f"Sink{p}")

    def check():
        total = sum(len(v) for v in received.values())
        if total != n_packets:
            return False, float(n_packets - total)
        bad = sum(1 for p, v in received.items()
                  for (d, _) in v if d != p)
        return bad == 0, float(bad)

    return Top, (), check


def run(engine: str = "coroutine", **kw) -> AppResult:
    top, args, check = build(**kw)
    return simulate("network", top, args, engine, check)


# ---------------------------------------------------------------------------
# step-function form — the documented *refusal* case (docs/synthesis.md)
# ---------------------------------------------------------------------------

def build_step(n_packets: int = 64, seed: int = 0):
    """The Omega network with its injectors migrated to step-function
    form: each input line gets a LineSource with a build-time packet
    schedule (static firing count), closing its line after the last
    firing so the downstream free-form switches still see EoT.

    The 2x2 switch element itself **cannot** be a fixed-rate step task:
    it routes by peeking the head packet and forwards only when the
    *availability-chosen* output has space — the paper's beyond-KPN
    ``peek``/``select`` extension (Section 2.3).  Whole-graph synthesis
    therefore refuses this graph with a diagnostic naming the switch;
    it remains fully simulatable on every engine — exactly the
    sim-vs-synth boundary ``docs/synthesis.md`` documents.
    """
    rng = np.random.default_rng(seed)
    dsts = rng.integers(0, PORTS, n_packets)
    payloads = rng.integers(0, 1 << 32, n_packets)
    lines = rng.integers(0, PORTS, n_packets)
    per_line = [[(int(d), int(pl))
                 for d, pl, ln in zip(dsts, payloads, lines) if ln == p]
                for p in range(PORTS)]
    received: dict[int, list] = {p: [] for p in range(PORTS)}

    def make_line_source(p: int) -> StepTask:
        pkts = per_line[p]

        def line_source_step(k, out: OStream):
            out.write(pkts[int(k)])
            return k + 1

        return StepTask(line_source_step, steps=len(pkts), init=0,
                        close_outputs=True, name=f"LineSource{p}")

    line_sources = [make_line_source(p) for p in range(PORTS)]

    def Switch2x2(in0, in1, out0, out1, stage: int):
        bit = STAGES - 1 - stage
        open_in = [False, False]
        ins = [in0, in1]
        outs = [out0, out1]
        while not all(open_in):
            progress = False
            blockers = []
            for s in (0, 1):
                if open_in[s]:
                    continue
                ok, is_eot = ins[s].try_eot()
                if ok and is_eot:
                    ins[s].open()
                    open_in[s] = True
                    progress = True
                    continue
                ok, head = ins[s].try_peek()
                if not ok:
                    blockers.append(ins[s])
                    continue
                port = (head[0] >> bit) & 1
                if outs[port].try_write(head):
                    ins[s].read()
                    progress = True
                else:
                    blockers.append(outs[port])
            if not progress and blockers:
                select(*blockers)
        out0.close()
        out1.close()

    def Sink(inp, port: int):
        received[port].extend(inp.read_transaction())

    def Top():
        lines_ch = [[channel(4, f"l{s}_{i}") for i in range(PORTS)]
                    for s in range(STAGES + 1)]
        t = task()
        for p in range(PORTS):
            t = t.invoke(line_sources[p], lines_ch[0][p],
                         name=f"LineSource{p}")
        for s in range(STAGES):
            for e in range(PORTS // 2):
                i0 = _inv_shuffle(2 * e)
                i1 = _inv_shuffle(2 * e + 1)
                t = t.invoke(Switch2x2, lines_ch[s][i0], lines_ch[s][i1],
                             lines_ch[s + 1][2 * e],
                             lines_ch[s + 1][2 * e + 1],
                             s, name=f"SW{s}_{e}")
        for p in range(PORTS):
            t = t.invoke(Sink, lines_ch[STAGES][p], p, name=f"Sink{p}")

    def check():
        total = sum(len(v) for v in received.values())
        if total != n_packets:
            return False, float(n_packets - total)
        bad = sum(1 for p, v in received.items()
                  for (d, _) in v if d != p)
        return bad == 0, float(bad)

    return Top, (), check


def run_step(engine: str = "coroutine", device=None, **kw) -> AppResult:
    """Run the step-form graph; ``engine="compiled"`` (on ``device``, the
    card unless the caller asks for another) refuses it with a diagnostic
    naming the availability-routed switch."""
    top, args, check = build_step(**kw)
    ekw = {"device": resolve_device(device)} if engine == "compiled" \
        else None
    return simulate("network_step", top, args, engine, check,
                    engine_kwargs=ekw)

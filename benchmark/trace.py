"""Device time by layer, from a ``torch.profiler`` Chrome trace.

Each device event (kernel, copy, memset) is tied to the call that launched
it by the launch's ``correlation`` id, and that call to the CPU ops and
spans that enclose it on its thread (a copy of the port's ``tools/
step_profile.py::Links``). A layer is a span that the harness opens around
a call into that layer (``bench/depth_net``, ``bench/field``): a forward
kernel belongs to the layer whose span encloses its launch. A backward
kernel is launched inside an autograd ``...Backward`` op on the engine's
thread; that op carries the sequence number of the forward op that made
its node, and the kernel belongs to the layer of that forward op. So the
attribution reads no kernel's name: a kernel that replaces another is
counted where its caller is. Device time of no layer is ``other``.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CPU_CATS = ("cpu_op", "user_annotation")
SEQ, FWD_TID = "Sequence number", "Fwd thread id"
HOST_SPANS = ("dvd/step", "dvd/data_wait", "dvd/log_flush")


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e.get("dur", 0))


class Links:
    """Each device event's launch call and the CPU ops around it."""

    def __init__(self, events: List[dict]):
        self.launch = {}   # correlation id -> launch event
        self.parent = {}   # id(event) -> enclosing CPU event
        self.by_thread = collections.defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = e
            if cat in LAUNCH_CATS or cat in CPU_CATS:
                self.by_thread[(e.get("pid"), e.get("tid"))].append(e)
        for evs in self.by_thread.values():
            evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
            stack = []
            for e in evs:
                while stack and _end(stack[-1]) < _end(e):
                    stack.pop()
                if stack:
                    self.parent[id(e)] = stack[-1]
                stack.append(e)

    def launched_by(self, dev_event: dict) -> Optional[dict]:
        return self.launch.get(dev_event.get("args", {}).get("correlation"))

    def enclosing(self, e: Optional[dict]) -> List[dict]:
        """The CPU ops and spans around ``e``, innermost first."""
        out = []
        while e is not None:
            e = self.parent.get(id(e))
            if e is not None:
                out.append(e)
        return out


class Attribution:
    """Layer of each device event: the span of ``layers`` around its
    launch, or around the forward op of the backward op around it."""

    def __init__(self, events: List[dict], layers: Dict[str, str]):
        self.links = Links(events)
        self.layers = layers  # span name -> layer
        self.forward = {}     # sequence number -> layer of its forward op
        for evs in self.links.by_thread.values():
            if not any(e.get("name") in layers for e in evs):
                continue  # a thread that runs no layer's forward
            for e in evs:
                args = e.get("args", {})
                if args.get(SEQ, -1) < 0 or args.get(FWD_TID, 0):
                    continue
                layer = self._span_layer(e)
                if layer is not None:
                    self.forward.setdefault(args[SEQ], layer)

    def _span_layer(self, e: dict) -> Optional[str]:
        for op in [e] + self.links.enclosing(e):
            layer = self.layers.get(op.get("name"))
            if layer is not None:
                return layer
        return None

    def layer(self, dev_event: dict) -> str:
        launch = self.links.launched_by(dev_event)
        if launch is None:
            return "other"
        around = self.links.enclosing(launch)
        for op in around:
            layer = self.layers.get(op.get("name"))
            if layer is not None:
                return layer
        for op in around:
            args = op.get("args", {})
            if args.get(FWD_TID, 0) and args.get(SEQ, -1) >= 0:
                layer = self.forward.get(args[SEQ])
                if layer is not None:
                    return layer
        return "other"

    def op_name(self, dev_event: dict) -> str:
        """The outermost autograd or aten op around the launch (for the
        breakdown only)."""
        launch = self.links.launched_by(dev_event)
        ops = [op.get("name", "") for op in self.links.enclosing(launch)
               if op.get("cat") == "cpu_op"] if launch else []
        if not ops:
            return dev_event.get("cat", "?")
        name = ops[-1]
        return name.replace("autograd::engine::evaluate_function: ", "")


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float,
                                                                  float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def analyze(events: List[dict], layers: Dict[str, str]) -> Dict:
    """Per layer device seconds, the traced stretch, the device's busy
    seconds in it, the top device ops by layer and the idle gaps by the
    host span that was open in them. The stretch runs from the first host
    span of ``HOST_SPANS`` to the end of the last device event."""
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    if not device:
        return {}
    att = Attribution(events, layers)
    by_layer = collections.defaultdict(float)
    by_op = collections.defaultdict(float)
    for e in device:
        layer = att.layer(e)
        d = float(e.get("dur", 0)) / 1e6
        by_layer[layer] += d
        by_op[f"{layer}:{att.op_name(e)}"] += d
    spans = sorted((float(e["ts"]), _end(e), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("name") in HOST_SPANS)
    dev_iv = union((float(e["ts"]), _end(e)) for e in device)
    start = min([s[0] for s in spans] + [dev_iv[0][0]])
    stop = dev_iv[-1][1]
    busy = sum(b - a for a, b in dev_iv)
    gaps = [(start, dev_iv[0][0])] + [(dev_iv[i][1], dev_iv[i + 1][0])
                                      for i in range(len(dev_iv) - 1)]
    idle = collections.defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        open_ = [s for s in spans if s[0] <= mid <= s[1]]
        idle[open_[-1][2] if open_ else "none"] += (b - a) / 1e6
    launches = sum(1 for e in events if e.get("ph") == "X"
                   and e.get("cat") in LAUNCH_CATS
                   and "correlation" in e.get("args", {}))
    return {
        "layer_s": dict(by_layer),
        "window_s": (stop - start) / 1e6,
        "busy_s": busy / 1e6,
        "device_events": len(device),
        "unlinked": sum(1 for e in device
                        if att.links.launched_by(e) is None),
        "launches": launches,
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
    }

"""Device time, device idle time and host time by the program's own
layers, from a ``torch.profiler`` Chrome trace of the port's training
steps.

The program opens spans inside ``SceneFlowMotionFieldStep.train_step``:
``dvd/loss`` around the forward and the losses, holding ``dvd/depth_net``
and ``dvd/field``, then ``dvd/backward`` and ``dvd/optim``. A device event
belongs to the layer of the innermost of ``LAYER_SPANS`` around its
launch, or around the forward op of the backward op that launched it
(``trace.Attribution``, unchanged): ``loss`` is ``dvd/loss``'s self time,
kernels A and D, the geometry, the masked sums and the regularizer,
forward and backward; ``optim`` is what the optimizers' ``step`` launched.
Device time of no layer is ``other``. ``dvd/backward`` holds no layer's
kernels (each goes to its forward's layer): it is read as host time only.

Idle: each gap between the device's busy intervals (``trace.union``) in
``trace.analyze``'s traced stretch, from the first of ``trace.HOST_SPANS``
to the end of the last device event, is charged to the layer of the
device event that ends it: the work the device was waiting for the host
to launch. A gap ended by an event of no layer is ``other``'s. So the
layers' idle seconds sum to the stretch less the device's busy seconds.

Host: each step span's summed wall time on the host's timeline, nested
spans included. Under CUDA the profiler also writes a device-side copy of
each span (``gpu_user_annotation``, from its first kernel to its last);
that copy is not host time and is left out.
"""

from __future__ import annotations

from typing import Dict, List

from . import trace

LAYER_SPANS = {"dvd/depth_net": "depth_net", "dvd/field": "field",
               "dvd/loss": "loss", "dvd/optim": "optim"}
LAYERS = ("depth_net", "field", "loss", "optim", "other")
STEP_SPANS = ("dvd/loss", "dvd/depth_net", "dvd/field", "dvd/backward",
              "dvd/optim")


def analyze(events: List[dict]) -> Dict[str, Dict[str, float]]:
    """``{"device_s": {layer: s}, "idle_s": {layer: s}, "host_s": {span:
    s}}`` over every layer of ``LAYERS`` and span of ``STEP_SPANS``, or
    ``{}`` where the trace has no device event."""
    spans = [e for e in events if e.get("ph") == "X"]
    device = [e for e in spans if e.get("cat") in trace.DEVICE_CATS]
    if not device:
        return {}
    att = trace.Attribution(events, LAYER_SPANS)
    device_s = dict.fromkeys(LAYERS, 0.0)
    first = {}  # start of a device event -> its layer
    for e in device:
        layer = att.layer(e)
        device_s[layer] += float(e.get("dur", 0)) / 1e6
        first.setdefault(float(e["ts"]), layer)
    busy = trace.union((float(e["ts"]), float(e["ts"]) + float(
        e.get("dur", 0))) for e in device)
    start = min([float(e["ts"]) for e in spans
                 if e.get("name") in trace.HOST_SPANS] + [busy[0][0]])
    idle_s = dict.fromkeys(LAYERS, 0.0)
    for reach, (a, _) in zip([start] + [b for _, b in busy], busy):
        if a > reach:
            idle_s[first[a]] += (a - reach) / 1e6
    host_s = dict.fromkeys(STEP_SPANS, 0.0)
    for e in spans:  # not the device's copy of a span (gpu_user_annotation)
        if e.get("cat") == "user_annotation" and e.get("name") in host_s:
            host_s[e["name"]] += float(e.get("dur", 0)) / 1e6
    return {"device_s": device_s, "idle_s": idle_s, "host_s": host_s}

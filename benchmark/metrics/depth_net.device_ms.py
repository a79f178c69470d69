"""``depth_net.device_ms``: device time a step of what the depth net's
forward launched and of the backward ops of its forward ops, ms, over the
traced round."""


def read(run):
    t = run.trace
    if not t or not t["layer_s"].get("depth_net"):
        return None
    return 1e3 * t["layer_s"]["depth_net"] / len(t["gaps"])

"""Device ms per traced decision launched inside the program's vlfm.t5.decode spans (T5's greedy decoding loop in the veto's passes)."""


def read(ctx):
    tr = ctx.trace
    if not tr or not tr.decisions or "vlfm.t5.decode" not in tr.span_device_s:
        return None
    return 1e3 * tr.span_device_s["vlfm.t5.decode"] / tr.decisions

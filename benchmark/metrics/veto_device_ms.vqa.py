"""Device ms per traced decision launched inside the program's span named exactly vlfm.veto (the detection veto: the contour ring, each pass's visual prefix and T5), its child spans counted once."""


def read(ctx):
    tr = ctx.trace
    if not tr or not tr.decisions or "vlfm.veto" not in tr.span_device_s:
        return None
    return 1e3 * tr.span_device_s["vlfm.veto"] / tr.decisions

"""The share of the window's int8 conv launches that ran the kernel's
im2col body (the generic one, one sample per CTA), from the program's
launch counters by body (`int_conv.launches_by_design`), which the
driver reads before and after the window."""


def read(trace):
    launches = trace.extra.get("launches_by_design") or {}
    total = sum(launches.values())
    if total <= 0 or "im2col" not in launches:
        return None
    return 100.0 * launches["im2col"] / total

"""orb_describe's share of its roofline in the traced window (%): the sum of
its launches' least times (needed bytes at the HBM rate or needed float32
operations at the float32 rate) over its own device time."""

from slambench import need


def read(run):
    tr = run.trace
    return None if tr is None else need.roofline_percent(tr.describe_needs, tr.own_s["orb_describe"])

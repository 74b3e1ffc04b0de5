"""pose_solve's share of its roofline in the traced window (%), as
orb_describe_roofline, each launch's operations counted over the rows its
rounds visit."""

from slambench import need


def read(run):
    tr = run.trace
    return None if tr is None else need.roofline_percent(tr.pose_needs, tr.own_s["pose_solve"])

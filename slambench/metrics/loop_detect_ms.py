"""Host ms a keyframe of the loop closer's per-keyframe call on the thread
that tracks its sequence (vocabulary training on the first keyframes
included), over the window's keyframes."""


def read(run):
    s = run.spans["loop_detect"]
    return 1e3 * sum(s) / len(s) if s else None

"""Host ms of one unfenced parallel/dp_eval.py `dp_track_and_keyframe_step` call in
the window: the host's cost of issuing the batched step (host clock; where
the device's queue is full the wait for it is in it too)."""


def read(run):
    ms = run.dispatch_ms.get("keyframe")
    if not ms:
        return None
    return sum(ms) / len(ms)

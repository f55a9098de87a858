"""Host ms a window step spends uploading its frames (utils/device.py
`upload_image` for each sequence's left image, and right image on a
keyframe step, then one gather to the executions), host clock."""


def read(run):
    if not run.upload_ms:
        return None
    return sum(run.upload_ms) / len(run.upload_ms)

"""Batched inference helpers and the wild command lines' video metadata."""


def read_video_meta(vid_path: str):
    """(fps, (w, h)) of a video through ``cv2.VideoCapture`` (shared by the
    wild command lines; ``motionbert_tpu/infer/__init__.py`` reads it through
    imageio). fps is 30.0 where the container records none. Raises when the
    file cannot be opened."""
    import cv2

    cap = cv2.VideoCapture(vid_path)
    try:
        if not cap.isOpened():
            raise OSError(f"cv2.VideoCapture cannot open {vid_path}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    finally:
        cap.release()
    return float(fps), size

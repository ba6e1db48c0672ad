from .detection import Detection, DetectNet
from .runtime import Pipeline, StageStats
from .streamer import (CaptureStreamer, ImageListStreamer, VideoListStreamer,
                       open_stream)

__all__ = ["Detection", "DetectNet", "Pipeline", "StageStats",
           "CaptureStreamer", "ImageListStreamer", "VideoListStreamer",
           "open_stream"]

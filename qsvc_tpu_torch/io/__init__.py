from .yuv import Video, psnr, synthetic_video, video_psnr  # noqa: F401

from .yuv import (Video, read_yuv, write_yuv, synthetic_video,  # noqa: F401
                  parse_geometry, psnr, video_psnr)

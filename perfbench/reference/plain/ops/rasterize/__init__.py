from .config import RasterConfig

from .pipeline import (DataConfig, TokenPipeline, make_pipeline,
                       write_token_file)

__all__ = ["DataConfig", "TokenPipeline", "make_pipeline",
           "write_token_file"]

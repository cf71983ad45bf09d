from repro_torch.metrics.fid import (feature_stats, fid_score,
                                     frechet_distance,
                                     make_feature_extractor,
                                     make_token_feature_extractor)

__all__ = ["feature_stats", "fid_score", "frechet_distance",
           "make_feature_extractor", "make_token_feature_extractor"]

from repro_torch.comm.bucketing import (BucketPlan, make_bucket_plan,
                                        pack_buckets, unpack_buckets)
from repro_torch.comm.compression import Int8Compressor, NoCompressor
from repro_torch.comm.engine import GradSyncEngine

__all__ = [
    "BucketPlan", "make_bucket_plan", "pack_buckets", "unpack_buckets",
    "GradSyncEngine", "Int8Compressor", "NoCompressor",
]

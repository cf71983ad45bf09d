from repro_torch.data.partition import partition, partition_iid
from repro_torch.data.synthetic import (DATASET_SPECS, make_image_dataset,
                                        make_token_dataset)

__all__ = ["partition", "partition_iid", "DATASET_SPECS",
           "make_image_dataset", "make_token_dataset"]

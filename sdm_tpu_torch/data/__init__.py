from sdm_tpu_torch.data.datasets import (ConditionalImgDataset,
                                        DoodleImgDataset, ImageDataset)
from sdm_tpu_torch.data.loader import DataLoader

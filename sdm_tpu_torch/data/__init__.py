from sdm_tpu_torch.data.datasets import ConditionalImgDataset, ImageDataset
from sdm_tpu_torch.data.loader import DataLoader

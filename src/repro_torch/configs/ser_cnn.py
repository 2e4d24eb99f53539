"""The paper's own model: lightweight 1D CNN for Speech Emotion
Recognition (paper Sec. 3.1), trained federated with DP-SGD."""
from repro_torch.models.ser_cnn import SERConfig

CONFIG = SERConfig()

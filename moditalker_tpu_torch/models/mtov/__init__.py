from .autoencoder import ViTAutoencoder  # noqa: F401
from .ddpm import MtovDDPM  # noqa: F401
from .timesformer import TimeSformerDecoder, TimeSformerEncoder  # noqa: F401
from .unet import TriplaneUNet  # noqa: F401

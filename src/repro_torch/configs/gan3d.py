"""3DGAN config — the paper's CERN workload (not one of the LM archs)."""
from repro_torch.models.gan3d import GAN3DConfig

CONFIG = GAN3DConfig()
SMOKE_CONFIG = GAN3DConfig(name="3dgan-smoke", g_base=8, d_base=4)

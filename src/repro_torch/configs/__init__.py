"""Architecture configs.  Importing this package registers every arch."""
from repro_torch.configs.base import ARCHS, ModelConfig, get_arch

# Register the architectures (import side effect).
from repro_torch.configs import deepseek_v2_lite_16b  # noqa: F401,E402
from repro_torch.configs import falcon_mamba_7b  # noqa: F401,E402
from repro_torch.configs import internlm2_20b  # noqa: F401,E402
from repro_torch.configs import kimi_k2_1t_a32b  # noqa: F401,E402
from repro_torch.configs import paper_models  # noqa: F401,E402
from repro_torch.configs import phi4_mini_3_8b  # noqa: F401,E402
from repro_torch.configs import qwen2_0_5b  # noqa: F401,E402
from repro_torch.configs import qwen2_vl_72b  # noqa: F401,E402
from repro_torch.configs import recurrentgemma_9b  # noqa: F401,E402
from repro_torch.configs import tinyllama_1_1b  # noqa: F401,E402
from repro_torch.configs import whisper_small  # noqa: F401,E402

__all__ = ["ARCHS", "ModelConfig", "get_arch"]

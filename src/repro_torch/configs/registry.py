"""Architecture registry: --arch <id> resolution."""
from .base import ArchConfig
from .h2o_danube_1_8b import CONFIG as _danube
from .gemma3_4b import CONFIG as _gemma3
from .yi_34b import CONFIG as _yi
from .gemma2_27b import CONFIG as _gemma2
from .llama_3_2_vision_11b import CONFIG as _llamav
from .granite_moe_3b_a800m import CONFIG as _granite
from .deepseek_moe_16b import CONFIG as _dsmoe
from .zamba2_7b import CONFIG as _zamba
from .mamba2_130m import CONFIG as _mamba
from .hubert_xlarge import CONFIG as _hubert

ARCHS = {c.name: c for c in (_danube, _gemma3, _yi, _gemma2, _llamav,
                             _granite, _dsmoe, _zamba, _mamba, _hubert)}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return ARCHS[name[:-6]].reduced()
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)

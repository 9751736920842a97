"""The paper's own workload config: COSMO hdiff on a 256 x 256 x 64 grid
(§4.1: "We run all our experiments using a 256x256x64-point domain similar
to the grid domain used by the COSMO weather prediction model"), fp32."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class HdiffConfig:
    rows: int = 256
    cols: int = 256
    depth: int = 64
    coeff: float = 0.025
    dtype: str = "float32"
    n_timesteps: int = 100
    limit: bool = True


CONFIG = HdiffConfig()


def smoke_config() -> HdiffConfig:
    return dataclasses.replace(CONFIG, rows=32, cols=32, depth=4, n_timesteps=3)

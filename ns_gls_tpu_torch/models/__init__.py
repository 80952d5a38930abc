from ns_gls_tpu_torch.models.base import BoundaryDescriptor, SimulationBase  # noqa
from ns_gls_tpu_torch.models.cylinder import SimulationCylinder  # noqa


def make_simulation(name: str, dim: int):
    if name == "cylinder":
        return SimulationCylinder(dim)
    if name in ("channel", "rotation", "sphere"):
        raise NotImplementedError(f"simulation '{name}' is not ported yet")
    raise ValueError(f"unknown simulation '{name}'")

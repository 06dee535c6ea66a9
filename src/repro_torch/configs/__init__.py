"""Architecture configs and input-shape cells (the port of the JAX
package's ``repro/configs``): the ids the port has are resolved by
:func:`repro_torch.configs.registry.get_arch`."""
from repro_torch.configs.registry import (ARCH_IDS, ArchSpec,
                                          get_arch)  # noqa: F401
from repro_torch.configs.shapes import (DIFFUSION_SHAPES, LM_SHAPES,
                                        ShapeCell, VISION_SHAPES, get_shape,
                                        shapes_for_family)  # noqa: F401

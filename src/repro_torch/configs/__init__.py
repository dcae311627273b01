from .base import ModelConfig, RegistrationConfig, ShapeConfig, SHAPES  # noqa: F401
from .registry import ARCHS, REGISTRATIONS, get_arch, get_registration, list_archs  # noqa: F401

from .model_api import Model, build_model, stack_plan

__all__ = ["Model", "build_model", "stack_plan"]

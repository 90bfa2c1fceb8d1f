from .base import ARCH_IDS, SHAPES, ArchConfig, ShapeSpec, cells_for, get_config, list_archs

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeSpec", "cells_for", "get_config", "list_archs"]

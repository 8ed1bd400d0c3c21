from .engine import SeedSearchEngine, HitProcessorParams

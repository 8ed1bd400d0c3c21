from .dispatcher import OutputDispatcher

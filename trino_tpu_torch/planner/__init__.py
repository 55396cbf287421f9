from .symbols import Symbol, SymbolAllocator, SymbolRef  # noqa: F401

class ArgumentError(Exception):
    """Raised when an argument is invalid.

    Kept distinct from ``ValueError`` so that library errors can be told apart
    from built-in ones (counterpart of ``krylov_tpu.errors.ArgumentError``).
    """

"""Term-name resolution for the energy dispatch.

``System`` special-cases terms by NAME ("IonIon" is skipped by the density
terms, "IonElectron" takes the external potential).  A term produced inside a
factory function has a ``__qualname__`` like ``make_term.<locals>.IonIon``;
its trailing segment is what dispatches, as in ``professad_tpu``.
"""

__all__ = ["term_name"]


def term_name(f):
    """Resolve a term callable's dispatch name: ``__qualname__``'s final
    segment, then ``__name__``, then the type name."""
    qn = getattr(f, "__qualname__", None)
    if qn:
        return qn.rsplit(".", 1)[-1]
    return getattr(f, "__name__", None) or type(f).__name__

"""Static/runtime type-checking interop.

``@contextmanager`` generator functions are annotated ``-> Iterator[T]``
— the convention every static checker expects — but runtime checkers
(typeguard's import hook, the executable half of this repo's typing gate:
``tests/test_typing.py``) instrument the *decorated* object, which
returns a ``_GeneratorContextManager``, and flag a false mismatch.

:func:`typeguard_exempt` marks exactly those functions: at runtime it is
``typing.no_type_check`` (which typeguard honors), while static checkers
see a plain identity decorator so the function stays fully checked.
"""

from typing import TYPE_CHECKING, Any, Callable, TypeVar

_F = TypeVar("_F", bound=Callable[..., Any])

if TYPE_CHECKING:

    def typeguard_exempt(func: _F) -> _F:
        """Identity for static analysis; runtime-check opt-out at runtime."""
        ...

else:
    from typing import no_type_check as typeguard_exempt

__all__ = ["typeguard_exempt"]

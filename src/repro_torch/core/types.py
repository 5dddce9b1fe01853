"""Logical data types for the columnar core.

These mirror the Arrow type system closely enough to express every data type
used in the paper's experiments (scalar, string, scalar-list, string-list,
vector = FixedSizeList<f32>, vector-list, image = Binary, image-list) plus
arbitrary Struct/List nesting for the property tests.

A type is *fixed width* when every value occupies the same number of bytes
(primitives and FixedSizeLists of fixed-width children).  Fixed-width-ness is
what the adaptive structural encoding keys off (together with the average
value size) -- see ``repro_torch.core.adaptive``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "DataType",
    "Primitive",
    "FixedSizeList",
    "List",
    "Struct",
    "Utf8",
    "Binary",
    "uint8",
    "int8",
    "int16",
    "int32",
    "int64",
    "uint32",
    "uint64",
    "float16",
    "float32",
    "float64",
    "utf8",
    "binary",
]


class DataType:
    """Base class for logical types."""

    nullable: bool

    def fixed_width(self) -> Optional[int]:
        """Bytes per value if the type is fixed width, else ``None``."""
        raise NotImplementedError

    # -- Dremel bookkeeping -------------------------------------------------
    def num_list_levels(self) -> int:
        """Number of (variable-size) List levels contained in this type path.

        FixedSizeList does NOT count: the paper treats primitive FSL arrays as
        primitive types (sec. 4.2) so it contributes no repetition.
        """
        raise NotImplementedError

    def with_nullable(self, nullable: bool) -> "DataType":
        return dataclasses.replace(self, nullable=nullable)


@dataclasses.dataclass(frozen=True)
class Primitive(DataType):
    dtype: str  # numpy dtype string, e.g. "int64", "float32"
    nullable: bool = True

    def fixed_width(self) -> Optional[int]:
        return int(np.dtype(self.dtype).itemsize)

    def num_list_levels(self) -> int:
        return 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{self.dtype}{'?' if self.nullable else ''}"


@dataclasses.dataclass(frozen=True)
class Utf8(DataType):
    nullable: bool = True

    def fixed_width(self) -> Optional[int]:
        return None

    def num_list_levels(self) -> int:
        return 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"utf8{'?' if self.nullable else ''}"


@dataclasses.dataclass(frozen=True)
class Binary(DataType):
    nullable: bool = True

    def fixed_width(self) -> Optional[int]:
        return None

    def num_list_levels(self) -> int:
        return 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"binary{'?' if self.nullable else ''}"


@dataclasses.dataclass(frozen=True)
class FixedSizeList(DataType):
    child: DataType = dataclasses.field(default_factory=lambda: Primitive("float32", nullable=False))
    size: int = 1
    nullable: bool = True

    def __post_init__(self) -> None:
        if self.child.fixed_width() is None:
            raise ValueError("FixedSizeList child must be fixed width")
        if self.child.nullable:
            # The paper treats FSL as a primitive: child validity is not part
            # of rep/def.  We require non-nullable children for simplicity.
            raise ValueError("FixedSizeList child must be non-nullable")

    def fixed_width(self) -> Optional[int]:
        return self.child.fixed_width() * self.size

    def num_list_levels(self) -> int:
        return 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"fsl<{self.child!r},{self.size}>{'?' if self.nullable else ''}"


@dataclasses.dataclass(frozen=True)
class List(DataType):
    child: DataType = dataclasses.field(default_factory=lambda: Primitive("int64"))
    nullable: bool = True

    def fixed_width(self) -> Optional[int]:
        return None

    def num_list_levels(self) -> int:
        return 1 + self.child.num_list_levels()

    def __repr__(self) -> str:  # pragma: no cover
        return f"list<{self.child!r}>{'?' if self.nullable else ''}"


@dataclasses.dataclass(frozen=True)
class Struct(DataType):
    fields: tuple = ()  # tuple[(name, DataType), ...]
    nullable: bool = True

    def fixed_width(self) -> Optional[int]:
        total = 0
        for _, f in self.fields:
            w = f.fixed_width()
            if w is None or f.nullable:
                return None
            total += w
        return total

    def num_list_levels(self) -> int:
        return max((f.num_list_levels() for _, f in self.fields), default=0)

    def field(self, name: str) -> DataType:
        for n, f in self.fields:
            if n == name:
                return f
        raise KeyError(name)

    def __repr__(self) -> str:  # pragma: no cover
        inner = ", ".join(f"{n}: {f!r}" for n, f in self.fields)
        return f"struct<{inner}>{'?' if self.nullable else ''}"


def uint8(nullable: bool = True) -> Primitive:
    return Primitive("uint8", nullable)


def int8(nullable: bool = True) -> Primitive:
    return Primitive("int8", nullable)


def int16(nullable: bool = True) -> Primitive:
    return Primitive("int16", nullable)


def int32(nullable: bool = True) -> Primitive:
    return Primitive("int32", nullable)


def int64(nullable: bool = True) -> Primitive:
    return Primitive("int64", nullable)


def uint32(nullable: bool = True) -> Primitive:
    return Primitive("uint32", nullable)


def uint64(nullable: bool = True) -> Primitive:
    return Primitive("uint64", nullable)


def float16(nullable: bool = True) -> Primitive:
    return Primitive("float16", nullable)


def float32(nullable: bool = True) -> Primitive:
    return Primitive("float32", nullable)


def float64(nullable: bool = True) -> Primitive:
    return Primitive("float64", nullable)


def utf8(nullable: bool = True) -> Utf8:
    return Utf8(nullable)


def binary(nullable: bool = True) -> Binary:
    return Binary(nullable)

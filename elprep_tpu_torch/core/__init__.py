from .header import Header, SortingOrder
from .batch import ReadBatch, TagsColumn

__all__ = ["Header", "SortingOrder", "ReadBatch", "TagsColumn"]

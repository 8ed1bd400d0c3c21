from .segments import Segment, SegmentTable
from .edit_script import EditScript, Alignment

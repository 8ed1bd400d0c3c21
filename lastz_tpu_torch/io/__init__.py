from .sequence import Sequence, SequenceFile, open_sequence_file

from .postable import PositionTable, build_seed_position_table

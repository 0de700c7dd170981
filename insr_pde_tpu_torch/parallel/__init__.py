from .mesh import (Group, broadcast, current_group, launch,  # noqa: F401
                   make_group, pmax, pmean, psum)

from flye_jax.assemble.chimera import ChimeraDetector
from flye_jax.assemble.extender import Extender, ContigPath
from flye_jax.assemble.driver import assemble_disjointigs

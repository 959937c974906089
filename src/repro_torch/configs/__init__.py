"""Model configurations of the port (copies of ``repro.configs``): the
architectures whose serving path is ported, through ``registry``."""

from repro_torch.pim.geometry import PCRAMGeometry, PCRAMTiming, PCRAMEnergy, OdinModule
from repro_torch.pim.commands import Command, command_set, TABLE1_EXPECTED, TABLE3_PJ
from repro_torch.pim.trace import (
    FC, Conv, Pool, Topology, trace_topology,
    CNN1, CNN2, VGG1, VGG2, PAPER_TOPOLOGIES,
)
from repro_torch.pim.baselines import CPUModel, ISAACModel, CPU32, CPU8, ISAAC_PIPE, ISAAC_UNPIPE

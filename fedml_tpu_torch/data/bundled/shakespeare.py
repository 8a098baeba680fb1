"""Mini-Shakespeare: the bundled REAL text (a copy of
``fedml_tpu/data/bundled/shakespeare.py``).

Genuine public-domain Shakespeare passages (plays first published
1597-1623), one speaking role per entry. The FedLLM path builds its
real-language instruction corpus from them
(:func:`fedml_tpu_torch.llm.data.shakespeare_instruction_corpus`), and
:func:`materialize_mini_shakespeare` writes it as a LEAF train/test split
(client = role, 80-character windows) for next-character prediction.
``tests/test_torch_llm.py`` pins the text and
``tests/test_torch_bundled_data.py`` the materialised split equal to the
JAX package's.
"""

from __future__ import annotations

import json
import os

# role -> passage. Public-domain text; sizes chosen so every client yields
# dozens of training windows.
PASSAGES = {
    "HAMLET": (
        "To be, or not to be, that is the question: "
        "Whether 'tis nobler in the mind to suffer "
        "The slings and arrows of outrageous fortune, "
        "Or to take arms against a sea of troubles, "
        "And by opposing end them. To die, to sleep; "
        "No more; and by a sleep to say we end "
        "The heartache and the thousand natural shocks "
        "That flesh is heir to: 'tis a consummation "
        "Devoutly to be wished. To die, to sleep; "
        "To sleep, perchance to dream. Ay, there's the rub, "
        "For in that sleep of death what dreams may come, "
        "When we have shuffled off this mortal coil, "
        "Must give us pause. There's the respect "
        "That makes calamity of so long life. "
        "For who would bear the whips and scorns of time, "
        "The oppressor's wrong, the proud man's contumely, "
        "The pangs of despised love, the law's delay, "
        "The insolence of office, and the spurns "
        "That patient merit of the unworthy takes, "
        "When he himself might his quietus make "
        "With a bare bodkin? Who would fardels bear, "
        "To grunt and sweat under a weary life, "
        "But that the dread of something after death, "
        "The undiscovered country from whose bourn "
        "No traveller returns, puzzles the will, "
        "And makes us rather bear those ills we have "
        "Than fly to others that we know not of?"
    ),
    "MACBETH": (
        "Tomorrow, and tomorrow, and tomorrow, "
        "Creeps in this petty pace from day to day, "
        "To the last syllable of recorded time; "
        "And all our yesterdays have lighted fools "
        "The way to dusty death. Out, out, brief candle! "
        "Life's but a walking shadow, a poor player, "
        "That struts and frets his hour upon the stage, "
        "And then is heard no more. It is a tale "
        "Told by an idiot, full of sound and fury, "
        "Signifying nothing. "
        "Is this a dagger which I see before me, "
        "The handle toward my hand? Come, let me clutch thee. "
        "I have thee not, and yet I see thee still. "
        "Art thou not, fatal vision, sensible "
        "To feeling as to sight? or art thou but "
        "A dagger of the mind, a false creation, "
        "Proceeding from the heat-oppressed brain?"
    ),
    "ROMEO": (
        "But, soft! what light through yonder window breaks? "
        "It is the east, and Juliet is the sun. "
        "Arise, fair sun, and kill the envious moon, "
        "Who is already sick and pale with grief, "
        "That thou her maid art far more fair than she. "
        "Be not her maid, since she is envious; "
        "Her vestal livery is but sick and green "
        "And none but fools do wear it; cast it off. "
        "It is my lady, O, it is my love! "
        "O, that she knew she were! "
        "She speaks yet she says nothing: what of that? "
        "Her eye discourses; I will answer it."
    ),
    "JULIET": (
        "O Romeo, Romeo! wherefore art thou Romeo? "
        "Deny thy father and refuse thy name; "
        "Or, if thou wilt not, be but sworn my love, "
        "And I'll no longer be a Capulet. "
        "'Tis but thy name that is my enemy; "
        "Thou art thyself, though not a Montague. "
        "What's Montague? it is nor hand, nor foot, "
        "Nor arm, nor face, nor any other part "
        "Belonging to a man. O, be some other name! "
        "What's in a name? that which we call a rose "
        "By any other name would smell as sweet."
    ),
    "PORTIA": (
        "The quality of mercy is not strained, "
        "It droppeth as the gentle rain from heaven "
        "Upon the place beneath: it is twice blest; "
        "It blesseth him that gives and him that takes: "
        "'Tis mightiest in the mightiest: it becomes "
        "The throned monarch better than his crown; "
        "His sceptre shows the force of temporal power, "
        "The attribute to awe and majesty, "
        "Wherein doth sit the dread and fear of kings; "
        "But mercy is above this sceptred sway; "
        "It is enthroned in the hearts of kings, "
        "It is an attribute to God himself."
    ),
    "ANTONY": (
        "Friends, Romans, countrymen, lend me your ears; "
        "I come to bury Caesar, not to praise him. "
        "The evil that men do lives after them; "
        "The good is oft interred with their bones; "
        "So let it be with Caesar. The noble Brutus "
        "Hath told you Caesar was ambitious: "
        "If it were so, it was a grievous fault, "
        "And grievously hath Caesar answered it. "
        "Here, under leave of Brutus and the rest - "
        "For Brutus is an honourable man; "
        "So are they all, all honourable men - "
        "Come I to speak in Caesar's funeral. "
        "He was my friend, faithful and just to me."
    ),
    "HENRY": (
        "Once more unto the breach, dear friends, once more; "
        "Or close the wall up with our English dead. "
        "In peace there's nothing so becomes a man "
        "As modest stillness and humility: "
        "But when the blast of war blows in our ears, "
        "Then imitate the action of the tiger; "
        "Stiffen the sinews, summon up the blood, "
        "Disguise fair nature with hard-favoured rage; "
        "Then lend the eye a terrible aspect."
    ),
    "JAQUES": (
        "All the world's a stage, "
        "And all the men and women merely players: "
        "They have their exits and their entrances; "
        "And one man in his time plays many parts, "
        "His acts being seven ages. At first the infant, "
        "Mewling and puking in the nurse's arms. "
        "And then the whining schoolboy, with his satchel "
        "And shining morning face, creeping like snail "
        "Unwillingly to school. And then the lover, "
        "Sighing like furnace, with a woeful ballad "
        "Made to his mistress' eyebrow."
    ),
    "RICHARD": (
        "Now is the winter of our discontent "
        "Made glorious summer by this sun of York; "
        "And all the clouds that loured upon our house "
        "In the deep bosom of the ocean buried. "
        "Now are our brows bound with victorious wreaths; "
        "Our bruised arms hung up for monuments; "
        "Our stern alarums changed to merry meetings, "
        "Our dreadful marches to delightful measures."
    ),
    "PROSPERO": (
        "Our revels now are ended. These our actors, "
        "As I foretold you, were all spirits and "
        "Are melted into air, into thin air: "
        "And, like the baseless fabric of this vision, "
        "The cloud-capped towers, the gorgeous palaces, "
        "The solemn temples, the great globe itself, "
        "Yea, all which it inherit, shall dissolve "
        "And, like this insubstantial pageant faded, "
        "Leave not a rack behind. We are such stuff "
        "As dreams are made on, and our little life "
        "Is rounded with a sleep."
    ),
}

SEQ_LEN = 80


def _windows(text: str, seq_len: int = SEQ_LEN, stride: int = 11):
    """Overlapping (x, y) pairs: y is x shifted one character — per-token
    next-char prediction (SequenceTrainer's label layout)."""
    xs, ys = [], []
    for start in range(0, len(text) - seq_len - 1, stride):
        xs.append(text[start:start + seq_len])
        ys.append(text[start + 1:start + seq_len + 1])
    return xs, ys


def materialize_mini_shakespeare(root: str) -> str:
    """Write the bundled shard as LEAF train/test JSON under
    ``root/shakespeare``; returns that directory. Idempotent."""
    base = os.path.join(root, "shakespeare")
    done = os.path.join(base, ".bundled")
    if os.path.exists(done):
        return base
    train_users, test_users = {}, {}
    for role, text in PASSAGES.items():
        xs, ys = _windows(text)
        n_test = max(len(xs) // 10, 1)
        train_users[role] = {"x": xs[:-n_test], "y": ys[:-n_test]}
        test_users[role] = {"x": xs[-n_test:], "y": ys[-n_test:]}
    for split, users in (("train", train_users), ("test", test_users)):
        d = os.path.join(base, split)
        os.makedirs(d, exist_ok=True)
        blob = {"users": sorted(users),
                "num_samples": [len(users[u]["x"]) for u in sorted(users)],
                "user_data": users}
        with open(os.path.join(d, "data.json"), "w") as f:
            json.dump(blob, f)
    with open(done, "w") as f:
        f.write("mini-shakespeare v1\n")
    return base
